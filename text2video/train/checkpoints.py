"""Orbax checkpointing for GAN training and renderer loading.

The reference's only checkpointing is vid2vid's per-person GAN weight
files downloaded by hand (reference: README.md:20-34, --save_epoch_freq
100 at :175). Here: Orbax-managed checkpoints of the full trainer state
(G/D params, both optimizer states, step), plus a renderer loader that
pulls just the generator params for inference.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import jax
import numpy as np

from text2video.config import PersonProfile, RenderConfig
from text2video.train.trainer import TrainConfig, TrainerState


def _orbax():
    """The checkpoint format's library, imported where a checkpoint is
    read or written: inference without ``--gan-checkpoint`` never needs
    it."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "GAN checkpoints need the 'orbax-checkpoint' package "
            "(import orbax.checkpoint), which is not installed"
        ) from e
    return ocp


def save_state(
    ckpt_dir: str,
    state: TrainerState,
    cfg: Optional[TrainConfig] = None,
    keep_last: int = 3,
) -> None:
    """Save a step checkpoint; retain only the newest ``keep_last``
    (a full trainer state is ~0.7 GB at production size)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    if cfg is not None:
        meta = {
            k: (str(v) if k == "dtype" else v)
            for k, v in dataclasses.asdict(cfg).items()
        }
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(meta, f, indent=1)
    with _orbax().StandardCheckpointer() as ck:
        ck.save(
            os.path.join(ckpt_dir, f"step_{int(state.step):08d}"),
            jax.tree.map(np.asarray, state),
        )
    if keep_last > 0:
        import shutil

        steps = sorted(
            d for d in os.listdir(ckpt_dir) if d.startswith("step_")
        )
        for old in steps[:-keep_last]:
            shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)


def load_config(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    # Orbax requires absolute restore paths. Incomplete saves (a crash
    # or kill mid-save leaves "step_*.orbax-checkpoint-tmp") are never
    # resume candidates — auto-resume must fall back to the newest
    # COMPLETE checkpoint.
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        d
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and "tmp" not in d
    )
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _is_legacy_layout(raw: dict, template: TrainerState) -> bool:
    """True when the raw tree is a known older architecture: separate
    img/flow/mask head convs, or fewer discriminators than the template
    (e.g. round-1 single-rate temporal D)."""
    g = raw.get("g_params") or {}
    p = g.get("params", g)
    if "img_head" in p:
        return True
    raw_d = raw.get("d_params")
    if isinstance(raw_d, dict) and isinstance(template.d_params, dict):
        if set(raw_d) < set(template.d_params):
            return True
    return False


def restore_state(ckpt_dir: str, template: TrainerState) -> TrainerState:
    path = latest_step_dir(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    ocp = _orbax()
    try:
        with ocp.StandardCheckpointer() as ck:
            return ck.restore(path, template)
    except Exception:
        # Architecture-migration fallback: restore raw, migrate generator
        # params, keep discriminators/VGG/step, re-init optimizer moments.
        # Only known legacy layouts migrate — anything else (corrupt
        # checkpoint, dtype drift) re-raises rather than silently
        # resetting Adam moments.
        with ocp.PyTreeCheckpointer() as ck:
            raw = ck.restore(path)
        if not _is_legacy_layout(raw, template):
            raise
        import logging

        import jax.numpy as jnp

        logging.getLogger(__name__).warning(
            "migrating legacy checkpoint %s: optimizer state re-initialized",
            path,
        )
        g_params = jax.tree.map(
            jnp.asarray, migrate_generator_params(raw["g_params"])
        )
        d_params = jax.tree.map(jnp.asarray, raw["d_params"])
        if isinstance(d_params, dict) and isinstance(template.d_params, dict):
            # New discriminators (e.g. the stride-2 temporal D) start
            # from the template's fresh init.
            for k, v in template.d_params.items():
                d_params.setdefault(k, v)
        vgg = raw.get("vgg_params")
        if vgg is not None:
            vgg = jax.tree.map(jnp.asarray, vgg)
        return template.replace(
            step=jnp.asarray(raw["step"], jnp.int32),
            g_params=g_params,
            d_params=d_params,
            vgg_params=vgg if vgg is not None else template.vgg_params,
        )


def migrate_generator_params(g_params: Any) -> Any:
    """Upgrade pre-merged-head generator params: the separate
    img/flow/mask 7x7 head convs concatenate (on the output-channel axis)
    into the single "heads" conv — mathematically identical."""
    p = g_params["params"] if "params" in g_params else g_params
    trunk = p.get("GlobalTrunk_0", {})
    if "ConvBlock_1" in trunk and "Conv_0" in trunk.get("ConvBlock_1", {}):
        k1 = np.shape(trunk["ConvBlock_0"]["Conv_0"]["kernel"])
        k2 = np.shape(trunk["ConvBlock_1"]["Conv_0"]["kernel"])
        if len(k1) == 4 and len(k2) == 4 and k1[:2] == (7, 7) and k2[:2] == (7, 7):
            raise ValueError(
                "checkpoint uses the legacy two-branch encoder; it cannot "
                "be migrated exactly to the single-encoder generator — "
                "retrain (train-gan) to produce a current checkpoint"
            )
    if "img_head" not in p:
        return g_params
    heads = {
        "kernel": np.concatenate(
            [
                np.asarray(p["img_head"]["kernel"]),
                np.asarray(p["flow_head"]["kernel"]),
                np.asarray(p["mask_head"]["kernel"]),
            ],
            axis=-1,
        ),
        "bias": np.concatenate(
            [
                np.asarray(p["img_head"]["bias"]),
                np.asarray(p["flow_head"]["bias"]),
                np.asarray(p["mask_head"]["bias"]),
            ]
        ),
    }
    new = {k: v for k, v in p.items()
           if k not in ("img_head", "flow_head", "mask_head")}
    new["heads"] = heads
    return {"params": new} if "params" in g_params else new


def restore_generator_params(ckpt_dir: str) -> Any:
    """Restore only the generator params pytree (for inference)."""
    path = latest_step_dir(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    with _orbax().PyTreeCheckpointer() as ck:
        tree = ck.restore(path)
    return migrate_generator_params(tree["g_params"])


def load_renderer(
    ckpt_dir: str,
    profile: PersonProfile,
    decode_mode: str = "scan",
    jacobi_sweeps: int = 3,
):
    """Build an inference Renderer from a training checkpoint (generator
    hyperparameters come from the checkpoint's config.json).

    decode_mode/jacobi_sweeps select the decoding strategy
    (config.RenderConfig: exact sequential scan vs batched Jacobi
    fixed-point sweeps)."""
    import jax.numpy as jnp

    from text2video.models.generator import CompositeGenerator
    from text2video.render import Renderer

    meta = load_config(ckpt_dir) or {}
    gen = CompositeGenerator(
        base_ch=int(meta.get("base_ch", 64)),
        n_blocks=int(meta.get("n_blocks", 9)),
        dtype=jnp.bfloat16,
    )
    # Run the GAN at its *trained* height: a checkpoint trained at e.g.
    # 512 drives a 1080p-canvas person through the scaleHeight-512 path
    # (reference: --loadSize 512 --resize_or_crop scaleHeight,
    # text2video_audio.sh:42), not at the person's canvas resolution.
    load_size = int(meta["height"]) if "height" in meta else None
    return Renderer(
        generator=gen,
        params=restore_generator_params(ckpt_dir),
        config=RenderConfig(
            load_size=load_size,
            decode_mode=decode_mode,
            jacobi_sweeps=jacobi_sweeps,
        ),
    )
