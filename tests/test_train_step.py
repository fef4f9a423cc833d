"""Train-step smoke tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from text2video.parallel.mesh import make_mesh, param_specs
from text2video.train.trainer import (
    TrainConfig,
    create_trainer_state,
    make_train_step,
)

CFG = TrainConfig(
    height=32,
    width=32,
    face_crop=8,
    base_ch=8,
    n_blocks=1,
    d_base_ch=8,
    use_vgg=False,
    dtype=jnp.float32,
)


def _batch(b=2, t=4):
    rng = np.random.RandomState(0)
    return {
        "labels": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "reals": rng.rand(b, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "face_centers": np.full((b, t, 2), 16.0, np.float32),
    }


def test_train_step_updates_params_and_losses_finite():
    state = create_trainer_state(CFG)
    step = jax.jit(make_train_step(CFG))
    batch = _batch()
    new_state, metrics = step(state, batch)
    assert int(new_state.step) == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), (k, float(v))
    # Both G and D parameters must have moved.
    g_delta = jax.tree.reduce(
        lambda a, b: a + b,
        jax.tree.map(
            lambda a, b: float(jnp.sum(jnp.abs(a - b))),
            state.g_params,
            new_state.g_params,
        ),
    )
    d_delta = jax.tree.reduce(
        lambda a, b: a + b,
        jax.tree.map(
            lambda a, b: float(jnp.sum(jnp.abs(a - b))),
            state.d_params,
            new_state.d_params,
        ),
    )
    assert g_delta > 0 and d_delta > 0

    # Second step runs off the updated state (opt-state pytree round-trips).
    new_state2, _ = step(new_state, batch)
    assert int(new_state2.step) == 2


def test_train_step_sharded_matches_single_device():
    """DP over the 8-device CPU mesh must match the unsharded step."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    state = create_trainer_state(CFG)
    step = make_train_step(CFG)
    batch = _batch(b=8)

    _, metrics_ref = jax.jit(step)(state, batch)

    mesh = make_mesh(n_data=4, n_model=2)
    specs_state = jax.tree.map(lambda _: P(), state)
    specs_state = specs_state.replace(
        g_params=param_specs(state.g_params, mesh),
        d_params=param_specs(state.d_params, mesh),
    )

    def shard(specs):
        return jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            specs,
            is_leaf=lambda x: isinstance(x, P),
        )

    state_s = jax.device_put(state, shard(specs_state))
    batch_s = jax.device_put(
        batch, jax.tree.map(lambda _: NamedSharding(mesh, P("data")), batch)
    )
    _, metrics_sh = jax.jit(step)(state_s, batch_s)
    for k in metrics_ref:
        np.testing.assert_allclose(
            float(metrics_ref[k]), float(metrics_sh[k]), rtol=2e-3, atol=2e-5
        )


def test_recon_pretrain_mode_skips_discriminators():
    """lambda_adv=0 trains G by reconstruction only: adv/FM metrics are
    zero, D parameters stay at init, and repeated steps drive L1 down
    (the curriculum's pretrain phase — see TrainConfig.lambda_adv)."""
    cfg = TrainConfig(
        height=32, width=32, face_crop=8, base_ch=8, n_blocks=1,
        d_base_ch=8, use_vgg=False, lambda_adv=0.0, lambda_l1=10.0,
        lambda_flow=0.0, dtype=jnp.float32,
    )
    state = create_trainer_state(cfg)
    step = jax.jit(make_train_step(cfg))
    # A learnable (constant) target — random-noise reals have no
    # structure for L1 to fit, so the loss would sit at the noise floor.
    batch = _batch()
    batch["reals"] = np.full_like(batch["reals"], 0.5)
    s, m = state, None
    first_loss = None
    for _ in range(10):
        s, m = step(s, batch)
        if first_loss is None:
            first_loss = float(m["g_loss"])
    assert float(m["g_adv"]) == 0.0 and float(m["g_fm"]) == 0.0
    assert float(m["d_loss"]) == 0.0
    d_delta = jax.tree.reduce(
        lambda a, b: a + b,
        jax.tree.map(
            lambda a, b: float(jnp.sum(jnp.abs(a - b))),
            state.d_params,
            s.d_params,
        ),
    )
    assert d_delta == 0.0
    assert float(m["g_loss"]) < first_loss


def test_autoregressive_carry_is_detached():
    """Regression: gradients must NOT backprop through the generated
    frames fed back as next-step conditioning (cfg.bptt=False, vid2vid's
    fake_B_prev detach). Full BPTT compounds the CNN's input-to-output
    Jacobian over the T-step unroll — measured grad RMS ~1e4-1e5 at
    realistic depth, which reduces Adam updates to amplified noise and
    stalls training. Guard: the same step with bptt=True must produce a
    strictly larger gradient second-moment than the detached default."""
    rng = np.random.RandomState(1)
    t = 6
    batch = {
        "labels": rng.rand(1, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "reals": rng.rand(1, t, 32, 32, 3).astype(np.float32) * 2 - 1,
        "face_centers": np.full((1, t, 2), 16.0, np.float32),
    }

    def max_nu(bptt: bool) -> float:
        cfg = TrainConfig(
            height=32, width=32, face_crop=8, base_ch=8, n_blocks=2,
            d_base_ch=8, use_vgg=False, lambda_adv=0.0, lambda_l1=10.0,
            bptt=bptt, dtype=jnp.float32,
        )
        state = create_trainer_state(cfg)
        s, _ = jax.jit(make_train_step(cfg))(state, batch)
        return max(
            float(jnp.abs(v).max())
            for v in jax.tree_util.tree_leaves(s.g_opt[0].nu)
        )

    detached, full = max_nu(False), max_nu(True)
    assert detached < full, (detached, full)
    # Detached gradients stay O(1): second moment after one step is
    # 1e-3 * grad^2, so grad RMS = sqrt(nu / 1e-3) must be modest.
    assert (detached / 1e-3) ** 0.5 < 1e2, detached


def test_d_gradients_live_on_fakes():
    """Regression: the D objective must receive gradient from the
    fake->0 term, not only from reals (a stop_gradient on D *outputs*
    once zeroed it, collapsing adversarial training)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from text2video.train.trainer import (
        TrainConfig,
        create_trainer_state,
        make_train_step,
    )

    cfg = TrainConfig(
        height=32, width=32, face_crop=16, base_ch=4, n_blocks=1,
        d_base_ch=4, use_vgg=False, dtype=jnp.float32,
        temporal_strides=(1,),
    )
    state = create_trainer_state(cfg, seed=0)
    rng = np.random.RandomState(0)
    t = cfg.temporal_window + 1
    batch = {
        "labels": jnp.asarray(rng.randn(1, t, 32, 32, 3), jnp.float32),
        "reals": jnp.asarray(rng.randn(1, t, 32, 32, 3), jnp.float32),
        "face_centers": jnp.full((1, t, 2), 16.0, jnp.float32),
    }

    # Reals == a constant gray image would make real-only D gradients
    # vanish after it fits; instead compare D grads with fakes included
    # vs a D loss computed on reals only. Cheaper check: the d_loss
    # gradient w.r.t. d_params must differ when the generator params
    # change (only the fake branch depends on them).
    step = jax.jit(make_train_step(cfg))
    s1, m1 = step(state, batch)
    g2 = jax.tree.map(lambda x: x * 1.5, state.g_params)
    s2, m2 = step(state.replace(g_params=g2), batch)
    d_delta = jax.tree_util.tree_reduce(
        lambda a, b: a + float(jnp.abs(b).sum()),
        jax.tree.map(
            lambda a, b: a - b, s1.d_params, s2.d_params
        ),
        0.0,
    )
    assert d_delta > 1e-6, (
        "discriminator update is insensitive to the generator's output — "
        "the fake term contributes no gradient"
    )


def test_grad_accum_matches_full_batch():
    """grad_accum=2 must reproduce the full-batch step exactly (every
    loss is a batch mean over equal micro-batches), at ~half the peak
    activation memory."""
    import dataclasses

    state0 = create_trainer_state(CFG)
    batch = _batch(b=2)
    full_step = jax.jit(make_train_step(CFG))
    accum_step = jax.jit(
        make_train_step(dataclasses.replace(CFG, grad_accum=2))
    )
    s_full, m_full = full_step(state0, batch)
    s_acc, m_acc = accum_step(state0, batch)
    for k in m_full:
        np.testing.assert_allclose(
            np.asarray(m_full[k]), np.asarray(m_acc[k]),
            rtol=2e-4, atol=1e-5, err_msg=k,
        )
    # At step 1 Adam's update is ~ +-lr * sign(grad) (zero moments), so
    # f32 reduction-order noise on near-zero gradients can flip a sign
    # and move a parameter by 2*lr. Assert the aggregate structure: no
    # element moves more than one Adam step apart, and almost all match.
    diffs = np.concatenate(
        [
            np.abs(np.asarray(a) - np.asarray(b)).ravel()
            for a, b in zip(
                jax.tree.leaves(s_full.g_params),
                jax.tree.leaves(s_acc.g_params),
            )
        ]
    )
    assert diffs.max() <= 2.5 * CFG.lr
    # A fresh network has many near-zero gradients whose Adam step-1
    # sign is noise; ~3-4% flip in practice on this tiny model.
    assert (diffs > 1e-5).mean() < 0.06


def test_safe_grad_accum_hazard_rule():
    """trainer.safe_grad_accum caps per-micro-batch unrolled frames at
    896x512-class resolutions (the measured composed-step NaN hazard)
    and never touches small-canvas or batch-1 configs."""
    from text2video.train.trainer import TrainConfig, safe_grad_accum

    small = TrainConfig(height=384, width=512)
    big = TrainConfig(height=512, width=896)

    # 512x384: finite at every probed shape -> untouched.
    assert safe_grad_accum(small, 8, 12) == 1
    # The known-NaN shape: batch 4 x clip 8 at 896x512 -> micro-batched.
    acc = safe_grad_accum(big, 4, 8)
    assert acc > 1 and 4 % acc == 0
    assert (4 // acc) * 8 <= 16
    # The known-finite shapes stay at the requested accumulation.
    assert safe_grad_accum(big, 2, 8) == 1
    assert safe_grad_accum(big, 1, 8) == 1
    # An explicit user request is the floor, never lowered.
    assert safe_grad_accum(
        TrainConfig(height=512, width=896, grad_accum=4), 4, 8
    ) == 4
    # Non-power-of-two batches still land on a divisor.
    acc3 = safe_grad_accum(big, 3, 8)
    assert 3 % acc3 == 0 and (3 // acc3) * 8 <= 16


def test_mouth_l1_anchor_active_and_lowers_mouth_error():
    """--l1-mouth adds a mouth-crop L1 (the eval_gan 96px region): the
    metric reports it, it contributes gradient, and a few steps of
    mouth-only objective reduce the mouth-crop error."""
    import dataclasses

    cfg = dataclasses.replace(
        CFG, lambda_adv=0.0, lambda_l1=0.0, lambda_flow=0.0,
        lambda_l1_mouth=10.0,
    )
    state = create_trainer_state(cfg)
    step = jax.jit(make_train_step(cfg))
    batch = _batch()
    m0 = None
    for _ in range(6):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["g_mouth_l1"]))
        if m0 is None:
            m0 = float(metrics["g_mouth_l1"])
    assert float(metrics["g_mouth_l1"]) < m0, (m0, float(metrics["g_mouth_l1"]))

    # off by default: metric present but exactly zero
    state0 = create_trainer_state(CFG)
    _, metrics0 = jax.jit(make_train_step(CFG))(state0, batch)
    assert float(metrics0["g_mouth_l1"]) == 0.0
