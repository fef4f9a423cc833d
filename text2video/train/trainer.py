"""The sharded GAN train step.

One optimisation step consumes a clip batch — ``labels``/``reals`` of
shape [B, T, H, W, 3] plus per-frame face centres [B, T, 2] — mirroring
the reference's 12-frame clip sampling (``--n_frames_total 12``,
README.md:173). The generator unrolls autoregressively over T inside
``lax.scan`` (gradients flow through the scan); discriminators score each
frame, a temporal discriminator scores stacked triples, and a face
discriminator scores crops around the mouth centre (``--add_face_disc``).

G and D updates are computed in the same jitted program from ONE
generator forward: the G objective unrolls the generator and returns the
fakes as auxiliary output; the D objective re-applies only the (cheap)
discriminators to those fakes as constants — matching vid2vid's
detach-the-images G/D alternation without a second generator unroll.
Under jit with a mesh the batch axis shards over the "data" axis and
gradients all-reduce across it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from text2video.models import losses as L
from text2video.models.discriminator import (
    MultiscaleDiscriminator,
    face_crop,
)
from text2video.models.generator import CompositeGenerator
from text2video.models.vgg import VGG19Features


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    height: int = 384
    width: int = 512
    n_frames_ctx: int = 3  # label maps fed to G (current + 2 previous)
    use_prev_frames: int = 2
    temporal_window: int = 3  # frames stacked for the temporal D
    # Temporal D rates: stride-1 plus coarser strides (vid2vid scores
    # temporally downsampled stacks at multiple rates; reference README
    # trains with n_scales_temporal >= 2). Each rate has its own D.
    temporal_strides: Tuple[int, ...] = (1, 2)
    face_crop: int = 96
    base_ch: int = 64
    n_blocks: int = 9
    d_base_ch: int = 64
    num_d: int = 2
    lr: float = 2e-4
    beta1: float = 0.5
    # Discriminator learning-rate multiplier (reverse-TTUR). The full-size
    # Ds easily memorize a single-person dataset and saturate (d_loss ->
    # 0, adversarial gradient fighting reconstruction); slowing D keeps
    # the game informative in small-data regimes.
    d_lr_scale: float = 1.0
    # Weight on every adversarial G term (image/temporal/face). 0.0
    # statically disables the GAN game: no discriminator is applied or
    # updated and FM is off — pure reconstruction (L1/VGG/flow)
    # pretraining. Per-person datasets are tiny (a few thousand frames of
    # one subject); a fresh D memorizes them within a few hundred steps
    # and its saturated gradient then dominates G's update direction under
    # Adam's per-parameter normalization, stalling reconstruction. The
    # stable curriculum is recon pretrain (lambda_adv=0) then a short
    # adversarial finetune (resume with lambda_adv>0; D starts fresh).
    lambda_adv: float = 1.0
    lambda_fm: float = 10.0
    lambda_vgg: float = 10.0
    lambda_flow: float = 10.0
    lambda_face: float = 1.0
    lambda_temp: float = 1.0
    # Direct L1(fake, real) reconstruction. The vid2vid objective has no
    # raw L1 (feature matching plays that role), but vid2vid also has
    # ImageNet VGG19 weights; offline, VGG runs with *random* filters and
    # the measured ablation (README "Training-objective ablation") shows
    # random-VGG costs ~1.7 dB of early PSNR while a direct L1 anchor
    # recovers fastest. Defaults therefore encode the measured-best
    # offline recipe: L1 on, VGG off. Supplying real VGG19 weights
    # (models/vgg.load_params .npz -> create_trainer_state vgg_params)
    # with use_vgg=True restores the vid2vid-faithful perceptual term.
    lambda_l1: float = 10.0
    # Extra L1 on the mouth crop (the ``face_crop`` window around the
    # batch's mouth centers — the same 96 px region tools/eval_gan.py
    # scores). Round-4 finding: on synthetic-avatar identities the
    # adversarial phase LOWERS mouth PSNR while raising whole-frame
    # PSNR; this term anchors exactly the region the pipeline's
    # lip-sync quality rides on, steering the adversarial game instead
    # of just reporting the regression. 0 = off (the historical
    # objective).
    lambda_l1_mouth: float = 0.0
    use_vgg: bool = False
    # Rematerialize the per-frame generator forward (and VGG) in the
    # backward pass: the T-step scan otherwise saves every frame's
    # activations and runs out of device memory at full resolution.
    remat: bool = True
    # Label augmentation (train/augment.py; reference vid2vid
    # random_drop_prob / remove_face_labels, keypoint2img.py:119-123).
    # Only active in device-data training, where labels re-rasterize on
    # device each step.
    aug_jitter_px: float = 0.0
    aug_drop_prob: float = 0.0
    aug_face_drop_prob: float = 0.0
    # Random scaleHeight + aligned crop of reals AND keypoints each step
    # (reference README.md:169-171: --resize_or_crop
    # randomScaleHeight_and_scaledCrop --loadSize 544 --fineSize 512;
    # aug_scale_max = loadSize/fineSize - 1). Device-data training only
    # (labels re-rasterize from the transformed tracks on device).
    aug_scale_crop: bool = False
    aug_scale_max: float = 544.0 / 512.0 - 1.0
    # "photometric": self-supervised warp loss; "reference": supervise
    # against Farneback flow between the sampled real frames (vid2vid's
    # FlowNet-GT role; host data path only).
    flow_supervision: str = "photometric"
    # Split each step's batch into this many sequential micro-batches
    # (lax.scan inside the jitted step), averaging G and D gradients
    # before the single optimizer update. Gradients are mathematically
    # identical to the full batch (every loss term is a batch mean), but
    # peak activation memory drops by the accumulation factor, and the
    # compiled per-micro-batch program uses the small-batch tiling (the
    # workaround for the 896x512 batch-4 NaN tiling issue, README.md).
    grad_accum: int = 1
    # Backprop-through-time through the autoregressive feedback. False
    # (default) stops gradients on the generated frames fed back as the
    # next step's conditioning — vid2vid detaches fake_B_prev the same
    # way. Full BPTT compounds the CNN's input-to-output Jacobian gain
    # over the T-step unroll (measured: per-parameter gradient RMS ~1e5
    # at T=12/512x384 vs ~1e-1 per frame), so Adam sees amplified noise
    # and training stalls.
    bptt: bool = False
    dtype: Any = jnp.bfloat16


# --- 896-class lowering hazard -------------------------------------------
# Found on the earlier accelerator and unverified on the GPU: the
# composed train step returned NaN losses when one
# micro-batch's generator unroll covers too many frames at 896x512-class
# resolutions, even though the forward pass and each loss's gradient are
# individually finite at the identical shape (tools/nan_probe.py /
# tools/flow_nan_probe.py bisects; the warp gather alone is also clean,
# tools/warp_probe.py). Measured frontier, one jitted step with
# lambda_adv=0 + l1 + photometric flow:
#   512x384:  finite at every probed batch/clip combination
#   896x512:  batch 1 x clip 4 finite; batch 2 x clip 8 finite (the
#             henan_512 run trains 1200+ steps at that shape);
#             batch 4 x clip 8 NaN from step 1.
# Micro-batching is mathematically exact (equal-size means), so the fix
# is to cap per-micro-batch unrolled frames at hazardous resolutions by
# raising grad_accum automatically.
_HAZARD_PIXELS = 896 * 512
_HAZARD_SAFE_FRAMES = 16


def safe_grad_accum(cfg: "TrainConfig", batch_size: int, clip_len: int) -> int:
    """Smallest grad_accum >= cfg.grad_accum (dividing batch_size) whose
    micro-batch unrolled-frame count avoids the measured NaN hazard.

    Warns when no accumulation factor can dodge the hazard — i.e.
    clip_len alone exceeds the safe frontier at a hazardous resolution
    (e.g. --clip-len 32 at 896x512): the returned accum still runs, but
    the caller's "hazard dodged" assumption does not hold."""
    accum = max(int(cfg.grad_accum), 1)
    if cfg.height * cfg.width < _HAZARD_PIXELS:
        return accum
    while accum < batch_size and (
        (batch_size // accum) * clip_len > _HAZARD_SAFE_FRAMES
        or batch_size % accum
    ):
        accum += 1
    if (batch_size // accum) * clip_len > _HAZARD_SAFE_FRAMES:
        import warnings

        warnings.warn(
            f"grad accumulation cannot reach the safe unroll size at "
            f"{cfg.width}x{cfg.height}: micro-batch "
            f"{batch_size // accum} x clip_len {clip_len} = "
            f"{(batch_size // accum) * clip_len} frames > "
            f"{_HAZARD_SAFE_FRAMES}; NaN losses are likely — reduce "
            "--clip-len or the resolution.",
            stacklevel=2,
        )
    return accum


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainerState:
    step: jax.Array
    g_params: Any
    d_params: Any  # {"image": ..., "temporal": ..., "face": ...}
    vgg_params: Any
    g_opt: Any
    d_opt: Any

    def replace(self, **changes) -> "TrainerState":
        return dataclasses.replace(self, **changes)


def _temporal_key(stride: int) -> str:
    """d_params key for the stride-``s`` temporal D ("temporal" for the
    original stride-1 D, so round-1 checkpoints keep loading)."""
    return "temporal" if stride == 1 else f"temporal{stride}"


def _models(cfg: TrainConfig):
    gen = CompositeGenerator(
        base_ch=cfg.base_ch, n_blocks=cfg.n_blocks, dtype=cfg.dtype
    )
    d_image = MultiscaleDiscriminator(
        num_d=cfg.num_d, base_ch=cfg.d_base_ch, dtype=cfg.dtype
    )
    d_temporal = MultiscaleDiscriminator(
        num_d=1, base_ch=cfg.d_base_ch, dtype=cfg.dtype
    )
    d_face = MultiscaleDiscriminator(
        num_d=1, base_ch=cfg.d_base_ch // 2, dtype=cfg.dtype
    )
    vgg = VGG19Features(dtype=cfg.dtype) if cfg.use_vgg else None
    return gen, d_image, d_temporal, d_face, vgg


def _optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    return optax.adam(cfg.lr, b1=cfg.beta1, b2=0.999)


def _d_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    return optax.adam(cfg.lr * cfg.d_lr_scale, b1=cfg.beta1, b2=0.999)


def create_trainer_state(
    cfg: TrainConfig, seed: int = 0, vgg_params: Optional[Any] = None
) -> TrainerState:
    gen, d_image, d_temporal, d_face, vgg = _models(cfg)
    k = jax.random.PRNGKey(seed)
    kg, ki, kt, kf, kv = jax.random.split(k, 5)
    h, w = cfg.height, cfg.width
    labels = jnp.zeros((1, h, w, 3 * cfg.n_frames_ctx))
    prev = jnp.zeros((1, h, w, 3 * cfg.use_prev_frames))
    g_params = gen.init(kg, labels, prev, jnp.ones((1,)))
    d_params = {
        "image": d_image.init(ki, jnp.zeros((1, h, w, 6))),
        "face": d_face.init(
            kf, jnp.zeros((1, cfg.face_crop, cfg.face_crop, 6))
        ),
    }
    for i, s in enumerate(cfg.temporal_strides):
        d_params[_temporal_key(s)] = d_temporal.init(
            jax.random.fold_in(kt, i),
            jnp.zeros((1, h, w, 3 * cfg.temporal_window)),
        )
    if cfg.use_vgg and vgg_params is None:
        vgg_params = {
            "params": vgg.init(kv, jnp.zeros((1, 64, 64, 3)))["params"]
        }
    return TrainerState(
        step=jnp.zeros((), jnp.int32),
        g_params=g_params,
        d_params=d_params,
        vgg_params=vgg_params,
        g_opt=_optimizer(cfg).init(g_params),
        d_opt=_d_optimizer(cfg).init(d_params),
    )


def _generate_clip(gen, cfg: TrainConfig, g_params, labels, reals):
    """Unroll G over the clip. labels/reals: [B, T, H, W, 3] in [-1, 1].

    Matches inference conditioning (render.py): previous *generated*
    frames in the carry, previous labels as context. Returns fakes
    [B, T, H, W, 3] float32 and flows [B, T, H, W, 2].
    """
    b, t, h, w, _ = labels.shape
    dt = jnp.float32
    prev_imgs = jnp.zeros((b, h, w, 3 * cfg.use_prev_frames), dt)
    prev_labels = jnp.zeros((b, h, w, 3 * (cfg.n_frames_ctx - 1)), dt)

    labels_t = jnp.moveaxis(labels.astype(dt), 1, 0)

    gen_apply = gen.apply
    if cfg.remat:
        gen_apply = jax.checkpoint(gen_apply, static_argnums=())

    def step_fn(carry, lab):
        prev_i, prev_l, step = carry
        ctx = jnp.concatenate([lab, prev_l], axis=-1)
        has_prev = jnp.broadcast_to((step > 0).astype(dt), (b,))
        frame, flow, mask = gen_apply(g_params, ctx, prev_i, has_prev)
        frame = frame.astype(dt)
        fed_back = frame if cfg.bptt else jax.lax.stop_gradient(frame)
        new_prev_i = jnp.concatenate([fed_back, prev_i[..., :-3]], axis=-1)
        new_prev_l = jnp.concatenate([lab, prev_l[..., :-3]], axis=-1)
        return (new_prev_i, new_prev_l, step + 1), (frame, flow)

    _, (frames, flows) = jax.lax.scan(
        step_fn, (prev_imgs, prev_labels, jnp.zeros((), jnp.int32)), labels_t
    )
    return jnp.moveaxis(frames, 0, 1), jnp.moveaxis(flows, 0, 1)


def _flatten_bt(x):
    return x.reshape((-1,) + x.shape[2:])


def _temporal_stack(x, window: int, stride: int = 1):
    """[B, T, H, W, C] -> [B*n, H, W, C*window] stacks of ``window``
    frames spaced ``stride`` apart (vid2vid's temporally-downsampled
    discriminator inputs; stride 1 = consecutive frames)."""
    b, t, h, w, c = x.shape
    span = (window - 1) * stride + 1
    n = t - span + 1
    if n <= 0:
        raise ValueError(
            f"clip length {t} too short for temporal window {window} "
            f"at stride {stride}"
        )
    slices = [x[:, i * stride : i * stride + n] for i in range(window)]
    stacked = jnp.concatenate(slices, axis=-1)
    return stacked.reshape((-1, h, w, c * window))


def make_train_step(cfg: TrainConfig):
    """Returns step(state, batch) -> (state, metrics), ready for jit/pjit.

    batch: {"labels": [B,T,H,W,3] float in [-1,1],
            "reals":  [B,T,H,W,3] float in [-1,1],
            "face_centers": [B,T,2] float pixels}
    """
    gen, d_image, d_temporal, d_face, vgg = _models(cfg)
    opt = _optimizer(cfg)
    d_opt_tx = _d_optimizer(cfg)

    def d_apply_pairs(d_params, labels_f, frames_f):
        return d_image.apply(
            d_params["image"],
            jnp.concatenate([labels_f, frames_f], axis=-1),
        )

    def apply_discriminators(d_params, labels_f, frames, frames_f, centers_f):
        """Run every discriminator on one set of frames.

        frames: [B,T,H,W,3] float32 (for temporal stacks), frames_f the
        [B*T,...] flattening of the same. Returns (image_out,
        [temporal_out per stride], face_out)."""
        d_out = d_apply_pairs(d_params, labels_f, frames_f)
        # Coarser strides only apply when the clip is long enough to fit
        # the stretched window (e.g. tiny test clips run stride 1 only).
        t_outs = [
            d_temporal.apply(
                d_params[_temporal_key(s)],
                _temporal_stack(frames, cfg.temporal_window, s),
            )
            for s in cfg.temporal_strides
            if (cfg.temporal_window - 1) * s + 1 <= frames.shape[1]
        ]
        lab_crop = face_crop(labels_f, centers_f, cfg.face_crop)
        crop = face_crop(frames_f, centers_f, cfg.face_crop)
        f_out = d_face.apply(
            d_params["face"], jnp.concatenate([lab_crop, crop], -1)
        )
        return d_out, t_outs, f_out

    def g_objective(g_params, d_params, vgg_params, batch):
        """Full generator unroll + all G losses. Returns the fakes as aux
        so the D objective never re-runs the generator."""
        labels, reals = batch["labels"], batch["reals"]
        centers = batch["face_centers"]
        fakes, flows = _generate_clip(gen, cfg, g_params, labels, reals)
        reals_f32 = reals.astype(jnp.float32)

        labels_f = _flatten_bt(labels).astype(jnp.float32)
        fakes_f = _flatten_bt(fakes)
        reals_flat = _flatten_bt(reals_f32)
        centers_f = _flatten_bt(centers)

        if cfg.lambda_adv > 0.0:
            d_fake, t_fakes, f_fake = apply_discriminators(
                d_params, labels_f, fakes, fakes_f, centers_f
            )
            # Image-D real features are only needed as FM targets here.
            d_real = d_apply_pairs(d_params, labels_f, reals_flat)

            g_adv = cfg.lambda_adv * (
                L.lsgan_g(d_fake)
                + cfg.lambda_temp * sum(L.lsgan_g(t) for t in t_fakes)
                + cfg.lambda_face * L.lsgan_g(f_fake)
            )
            g_fm = L.feature_matching(d_real, d_fake)
        else:
            g_adv = jnp.zeros(())
            g_fm = jnp.zeros(())
        g_vgg = jnp.zeros(())
        if cfg.use_vgg:
            vgg_apply = (
                jax.checkpoint(vgg.apply) if cfg.remat else vgg.apply
            )
            vf = vgg_apply(vgg_params, fakes_f)
            vr = vgg.apply(vgg_params, jax.lax.stop_gradient(reals_flat))
            g_vgg = L.perceptual(vf, vr)
        if "flow_gt" in batch:
            # Reference-flow supervision (vid2vid's FlowNet role; here
            # Farneback fields from train/data.py).
            g_flow = L.flow_supervised_loss(
                _flatten_bt(flows[:, 1:]),
                _flatten_bt(batch["flow_gt"].astype(jnp.float32)),
            )
        else:
            g_flow = L.flow_loss(
                _flatten_bt(flows[:, 1:]),
                _flatten_bt(reals_f32[:, :-1]),
                _flatten_bt(reals_f32[:, 1:]),
            )
        g_loss = (
            g_adv
            + cfg.lambda_fm * g_fm
            + cfg.lambda_vgg * g_vgg
            + cfg.lambda_flow * g_flow
        )
        if cfg.lambda_l1 > 0.0:
            g_loss = g_loss + cfg.lambda_l1 * L.l1(fakes_f, reals_flat)
        g_mouth = jnp.zeros(())
        if cfg.lambda_l1_mouth > 0.0:
            # The batch's "face_centers" ARE mouth centers (points 48-59
            # mean, train/data.py:32-36) — the same window the face D
            # conditions on and tools/eval_gan.py scores.
            g_mouth = L.l1(
                face_crop(fakes_f, centers_f, cfg.face_crop),
                face_crop(reals_flat, centers_f, cfg.face_crop),
            )
            g_loss = g_loss + cfg.lambda_l1_mouth * g_mouth

        metrics = {
            "g_loss": g_loss,
            "g_adv": g_adv,
            "g_fm": g_fm,
            "g_vgg": g_vgg,
            "g_flow": g_flow,
            "g_mouth_l1": g_mouth,
        }
        return g_loss, (metrics, fakes)

    def d_objective(d_params, batch, fakes):
        """Discriminator losses only — ``fakes`` enter as constants (the
        detached images), so all D gradients are live on both the real
        and the fake terms."""
        labels, reals = batch["labels"], batch["reals"]
        centers = batch["face_centers"]
        reals_f32 = reals.astype(jnp.float32)
        labels_f = _flatten_bt(labels).astype(jnp.float32)
        fakes_f = _flatten_bt(fakes)
        reals_flat = _flatten_bt(reals_f32)
        centers_f = _flatten_bt(centers)
        d_fake, t_fakes, f_fake = apply_discriminators(
            d_params, labels_f, fakes, fakes_f, centers_f
        )
        d_real, t_reals, f_real = apply_discriminators(
            d_params, labels_f, reals_f32, reals_flat, centers_f
        )
        return (
            L.lsgan_d(d_real, d_fake)
            + sum(L.lsgan_d(tr, tf) for tr, tf in zip(t_reals, t_fakes))
            + L.lsgan_d(f_real, f_fake)
        )

    def grads_once(g_params, d_params, vgg_params, batch):
        """One G+D gradient evaluation on a (micro-)batch."""
        (g_loss, (metrics, fakes)), g_grads = jax.value_and_grad(
            g_objective, has_aux=True
        )(g_params, d_params, vgg_params, batch)
        if cfg.lambda_adv > 0.0:
            d_loss, d_grads = jax.value_and_grad(d_objective)(
                d_params, batch, jax.lax.stop_gradient(fakes)
            )
        else:
            d_loss = jnp.zeros(())
            d_grads = jax.tree.map(jnp.zeros_like, d_params)
        return g_grads, d_grads, dict(metrics, d_loss=d_loss)

    def step(state: TrainerState, batch) -> Tuple[TrainerState, Dict]:
        accum = max(int(cfg.grad_accum), 1)
        if accum == 1:
            g_grads, d_grads, metrics = grads_once(
                state.g_params, state.d_params, state.vgg_params, batch
            )
        else:
            # Sequential micro-batches inside the jitted step; averaged
            # gradients match the full batch exactly (all losses are
            # batch means over equal-size micro-batches).
            def to_micro(x):
                b = x.shape[0]
                if b % accum:
                    raise ValueError(
                        f"batch size {b} not divisible by grad_accum "
                        f"{accum}"
                    )
                return x.reshape((accum, b // accum) + x.shape[1:])

            micro = jax.tree.map(to_micro, batch)

            def scan_fn(acc, mb):
                g_g, d_g, m = grads_once(
                    state.g_params, state.d_params, state.vgg_params, mb
                )
                return jax.tree.map(jnp.add, acc, (g_g, d_g, m)), None

            zeros = jax.tree.map(
                jnp.zeros_like,
                jax.eval_shape(
                    lambda t: grads_once(
                        state.g_params, state.d_params,
                        state.vgg_params, t,
                    ),
                    jax.tree.map(lambda x: x[0], micro),
                ),
            )
            (g_grads, d_grads, metrics), _ = jax.lax.scan(
                scan_fn, zeros, micro
            )
            g_grads, d_grads, metrics = jax.tree.map(
                lambda x: x / accum, (g_grads, d_grads, metrics)
            )

        g_updates, g_opt = opt.update(g_grads, state.g_opt, state.g_params)
        if cfg.lambda_adv > 0.0:
            d_updates, d_opt = d_opt_tx.update(
                d_grads, state.d_opt, state.d_params
            )
            d_params = optax.apply_updates(state.d_params, d_updates)
        else:
            # Recon pretrain: Ds stay at init (fresh for the finetune).
            d_params, d_opt = state.d_params, state.d_opt

        new_state = state.replace(
            step=state.step + 1,
            g_params=optax.apply_updates(state.g_params, g_updates),
            d_params=d_params,
            g_opt=g_opt,
            d_opt=d_opt,
        )
        return new_state, metrics

    return step
