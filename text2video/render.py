"""Autoregressive pose2frame rendering engine.

Replaces the reference's per-frame GPU inference loop — vid2vid
``test.py --dataset_mode pose --openpose_only --no_first_img --how_many
1200`` walking JPEG label files one at a time (reference:
text2video_audio.sh:42; SURVEY.md §3.1 hot loop #4) — with a chunked
jitted ``lax.scan``:

  * label maps live on device as [B, chunk, H, W, 3] arrays (produced by
    ops/rasterize.py without touching disk);
  * the autoregressive dependence (each frame warps the previous output)
    is the scan carry, threaded across chunks so arbitrary utterance
    lengths reuse ONE compiled program (no per-length recompiles);
  * frames are converted to uint8 on device (4x smaller host transfer)
    and chunk transfers overlap the next chunk's compute (JAX dispatch is
    async — pulling chunk i blocks while chunk i+1 runs);
  * multiple utterances batch on the leading axis, sharded over the
    mesh's "data" axis — cross-utterance parallelism is how a sequential
    model fills several devices (SURVEY.md §2.5).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from text2video.config import RenderConfig
from text2video.models.generator import CompositeGenerator


@dataclasses.dataclass
class Renderer:
    """Holds generator params and the compiled chunked render program."""

    generator: CompositeGenerator
    params: dict
    config: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    # Frames per compiled chunk (also the Jacobi sweep batch). Bigger
    # buckets amortize per-chunk dispatch; smaller ones waste less
    # padding on short utterances and stream the first frames sooner.
    # Not yet tuned on the GPU.
    time_bucket: int = 64

    @staticmethod
    def create(
        config: Optional[RenderConfig] = None,
        height: int = 384,
        width: int = 512,
        seed: int = 0,
        base_ch: int = 64,
        n_blocks: int = 9,
        dtype=jnp.bfloat16,
        phase_form: bool = True,
    ) -> "Renderer":
        """Random-init renderer (weights come from training/checkpoints).

        phase_form=False runs the plain full-resolution decoder tail
        instead of the mathematically-identical phase form (the float32
        reference uses it)."""
        config = config or RenderConfig()
        gen = CompositeGenerator(base_ch=base_ch, n_blocks=n_blocks,
                                 dtype=dtype, phase_form=phase_form)
        labels = jnp.zeros((1, height, width, 3 * config.n_frames_ctx))
        prev = jnp.zeros((1, height, width, 3 * config.use_prev_frames))
        params = gen.init(jax.random.PRNGKey(seed), labels, prev, jnp.ones((1,)))
        return Renderer(generator=gen, params=params, config=config)

    # ------------------------------------------------------------------

    def init_carry(self, batch: int, height: int, width: int):
        """(prev_imgs, prev_labels, step) scan carry for a fresh utterance.

        Image/label state is kept in the GENERATOR's compute dtype
        (bfloat16 in production): the generator casts its inputs there
        anyway, so an f32 carry would only double the per-frame carry
        bytes without adding information."""
        cfg = self.config
        dt = self.generator.dtype
        return (
            jnp.zeros((batch, height, width, 3 * cfg.use_prev_frames), dt),
            jnp.zeros((batch, height, width, 3 * (cfg.n_frames_ctx - 1)),
                      dt),
            jnp.zeros((), jnp.int32),
        )

    def target_hw(self, h: int, w: int):
        """GAN working resolution for a (h, w) canvas: scaleHeight to
        config.load_size (multiples of 64 keep XLA tilings happy), or the
        canvas itself when load_size is None."""
        ls = self.config.load_size
        if ls is None or h == ls:
            return h, w
        h2 = max(round(ls / 64) * 64, 64)
        w2 = max(round(w * h2 / h / 64) * 64, 64)
        return h2, w2

    def _scan_chunk(self, params, labels, carry):
        """labels: [B, chunk, H, W, 3] in [-1,1] -> (frames [-1,1] in the
        generator dtype, carry). Labels resize on device to the working
        resolution first.

        The label-context window (current + n_frames_ctx-1 previous label
        maps) is assembled for the WHOLE chunk before the scan: the scan
        body then neither concatenates label context nor carries
        prev_labels frame to frame, for data that is known chunk-wide up
        front. Identical values reach the generator; only the schedule
        changes."""
        b, c, h, w, _ = labels.shape
        h2, w2 = self.target_hw(h, w)
        labels = labels.astype(jnp.float32)
        if (h2, w2) != (h, w):
            labels = jax.image.resize(
                labels, (b, c, h2, w2, 3), method="linear"
            )
        prev_imgs, prev_labels, step = carry
        dt = self.generator.dtype
        lab_t = jnp.moveaxis(labels, 1, 0).astype(dt)  # [C, B, H', W', 3]

        n_ctx = self.config.n_frames_ctx
        if c < n_ctx - 1:
            raise ValueError(
                f"chunk of {c} frames < n_frames_ctx-1 ({n_ctx - 1})"
            )
        ctx = [lab_t]
        for k in range(1, n_ctx):
            # shifted_k[i] = label of frame i-k; frames before the chunk
            # come from the carry (prev_labels[..., 3m:3m+3] = frame -1-m).
            head = [
                prev_labels[None, ..., 3 * (k - i - 1) : 3 * (k - i)]
                for i in range(k)
            ]
            ctx.append(jnp.concatenate(head + [lab_t[: c - k]], axis=0))
        labels_ctx_t = jnp.concatenate(ctx, axis=-1)

        steps = step + jnp.arange(c)
        has_prev_t = jnp.broadcast_to(
            (steps > 0).astype(jnp.float32)[:, None], (c, b)
        )

        def step_fn(prev, xs):
            lab_ctx, hp = xs
            frame, _, _ = self.generator.apply(params, lab_ctx, prev, hp)
            frame = frame.astype(dt)
            new_prev = jnp.concatenate([frame, prev[..., :-3]], axis=-1)
            return new_prev, frame

        prev_imgs, frames = jax.lax.scan(
            step_fn, prev_imgs.astype(dt), (labels_ctx_t, has_prev_t)
        )
        new_prev_labels = jnp.concatenate(
            [lab_t[c - 1 - m] for m in range(n_ctx - 1)], axis=-1
        )
        carry = (prev_imgs, new_prev_labels, step + c)
        return jnp.moveaxis(frames, 0, 1), carry  # [B, chunk, H', W', 3]

    def _render_chunk_impl(self, params, labels, carry):
        frames, carry = self._scan_chunk(params, labels, carry)
        # uint8 quantization in f32 (the cast fuses into this pass; bf16
        # ulp at 255 is 1, which would dither the low bit).
        frames_u8 = jnp.clip(
            (frames.astype(jnp.float32) + 1.0) * 127.5, 0.0, 255.0
        ).astype(jnp.uint8)
        return frames_u8, carry

    # ---- Jacobi (fixed-point) parallel decoding ----------------------

    def _jacobi_sweep_impl(self, params, labels_ctx, prev_imgs, has_prev):
        """One batched generator sweep over every frame at once.

        labels_ctx [T, H, W, 3*n_frames_ctx], prev_imgs [T, H, W,
        3*use_prev_frames], has_prev [T] -> frames [T, H, W, 3] in the
        GENERATOR dtype — the scan quantizes its carry to that dtype at
        the same point (render.py::_scan_chunk): the generator casts
        prev_imgs to its compute dtype on entry, so the scan and Jacobi
        recurrences are algorithmically identical either way
        (tools/jacobi_bisect_probe.py). The residual scan-vs-Jacobi
        difference is COMPILE-level: two differently-fused bf16 programs
        of the same generator differ by a few bf16 ulps per forward
        (tools/jacobi_bisect2.py), which the autoregressive warp
        recurrence amplifies on random weights (trained weights amplify
        far less, tools/jacobi_quality.py).
        The frame axis rides the generator's batch axis, unlike the
        scan's one-frame steps.
        """
        frame, _, _ = self.generator.apply(
            params, labels_ctx, prev_imgs, has_prev
        )
        return frame.astype(self.generator.dtype)

    @property
    def _jacobi_sweep(self):
        fn = getattr(self, "_jacobi_sweep_cache", None)
        if fn is None:
            fn = jax.jit(self._jacobi_sweep_impl)
            object.__setattr__(self, "_jacobi_sweep_cache", fn)
        return fn

    def render_jacobi(
        self, labels_u8: np.ndarray, sweeps: int = 3
    ) -> np.ndarray:
        """[T, H, W, 3] uint8 labels -> [T, H, W, 3] uint8 frames via
        Jacobi iteration on the autoregressive chain.

        The sequential scan is the fixed point of
            frames[t] = G(labels[t-ctx+1..t], frames[t-prev..t-1])
        Jacobi-iterate it: sweep the WHOLE timeline as one batched
        forward, feeding each frame the previous iterate's neighbours.
        Information propagates >=1 frame per sweep (frame 0 is exact on
        sweep 1 since it has no prev context), so ``sweeps >= T``
        reproduces the scan exactly in exact arithmetic — in float the
        batched-vs-scanned reduction-order noise (~1e-6) amplifies
        through the warp recurrence, so expect close-but-not-bitwise
        (tests/test_render_jacobi.py). Small sweep counts are the fast
        mode — the generator sees batch T
        instead of batch 1, trading k x FLOPs for wider batches, and
        each sweep's frames are independent so the batch axis can also
        shard over a mesh (the scan's sequential carry never can).
        """
        t = min(labels_u8.shape[0], self.config.max_frames)
        labels = jnp.asarray(
            labels_u8[:t].astype(np.float32) / 127.5 - 1.0
        )
        frames = self.jacobi_device(labels, sweeps)
        out = jnp.clip((frames + 1.0) * 127.5, 0.0, 255.0).astype(
            jnp.uint8
        )
        return np.asarray(out)

    def jacobi_device(self, labels: jax.Array, sweeps: int) -> jax.Array:
        """Device-side Jacobi sweeps: [T, H, W, 3] normalized labels ->
        [T, H', W', 3] float32 frames in [-1, 1], no host transfer."""
        t = labels.shape[0]
        cfg = self.config
        h, w = labels.shape[1:3]
        h2, w2 = self.target_hw(h, w)
        if (h2, w2) != (h, w):
            labels = jax.image.resize(
                labels, (t, h2, w2, 3), method="linear"
            )

        # Static label context: frame t sees labels[t], t-1, .. (zeros
        # before the start), exactly the scan's prev_labels carry. Like
        # the scan, the assembled context rides in the generator dtype
        # (same single f32->dt rounding; half the bytes).
        dt = self.generator.dtype
        ctx = [labels]
        for k in range(1, cfg.n_frames_ctx):
            ctx.append(
                jnp.pad(labels, ((k, 0), (0, 0), (0, 0), (0, 0)))[:t]
            )
        labels_ctx = jnp.concatenate(ctx, axis=-1).astype(dt)
        has_prev = (jnp.arange(t) > 0).astype(jnp.float32)

        # Sweep in fixed-size batch chunks (pad the tail so jit sees one
        # shape): batch `bucket` frames per generator call bounds peak
        # activation memory.
        bucket = min(self.time_bucket, t)
        pad_t = (-t) % bucket
        if pad_t:
            zpad = ((0, pad_t), (0, 0), (0, 0), (0, 0))
            labels_ctx = jnp.pad(
                labels_ctx, ((0, pad_t),) + zpad[1:]
            )
            has_prev = jnp.pad(has_prev, (0, pad_t))
        tt = t + pad_t

        # Frames live in the generator dtype between sweeps — same
        # values the generator would cast to on entry anyway, at half
        # the inter-sweep bytes (_jacobi_sweep docstring); the f32
        # upcast happens once at the end, mirroring _render_chunk_impl's
        # quantization pass.
        frames = jnp.zeros((t, h2, w2, 3), dt)
        for _ in range(max(int(sweeps), 1)):
            prev = [
                jnp.pad(frames, ((k, 0), (0, 0), (0, 0), (0, 0)))[:t]
                for k in range(1, cfg.use_prev_frames + 1)
            ]
            prev_imgs = jnp.concatenate(prev, axis=-1)
            if pad_t:
                prev_imgs = jnp.pad(prev_imgs, ((0, pad_t),) + zpad[1:])
            outs = [
                self._jacobi_sweep(
                    self.params,
                    labels_ctx[lo : lo + bucket],
                    prev_imgs[lo : lo + bucket],
                    has_prev[lo : lo + bucket],
                )
                for lo in range(0, tt, bucket)
            ]
            frames = jnp.concatenate(outs, axis=0)[:t]
        return frames.astype(jnp.float32)

    def _jacobi_sharded_impl(self, params, labels, has_prev, sweeps):
        """All `sweeps` Jacobi iterations as ONE jitted program over a
        time-sharded [T, H, W, 3] label array.

        The shifted prev-frame / prev-label windows become pad+slice on
        the sharded axis — XLA partitions them into neighbour
        `collective-permute`s (a 1-frame halo between devices), so a single
        utterance's timeline spans the mesh: the temporal parallelism the
        sequential scan structurally cannot have (SURVEY.md §2.5).
        """
        cfg = self.config
        t, h, w = labels.shape[:3]
        h2, w2 = self.target_hw(h, w)
        if (h2, w2) != (h, w):
            labels = jax.image.resize(
                labels, (t, h2, w2, 3), method="linear"
            )

        def shift(x, k):
            return jnp.pad(x, ((k, 0),) + ((0, 0),) * (x.ndim - 1))[:t]

        dt = self.generator.dtype
        ctx = [labels]
        for k in range(1, cfg.n_frames_ctx):
            ctx.append(shift(labels, k))
        labels_ctx = jnp.concatenate(ctx, axis=-1).astype(dt)

        # dt inter-sweep frames: same fixed point as the scan's dt carry
        # (_jacobi_sweep docstring).
        def body(_, frames):
            prev = jnp.concatenate(
                [shift(frames, k) for k in range(1, cfg.use_prev_frames + 1)],
                axis=-1,
            )
            out, _, _ = self.generator.apply(
                params, labels_ctx, prev, has_prev
            )
            return out.astype(dt)

        frames = jax.lax.fori_loop(
            0, sweeps, body, jnp.zeros((t, h2, w2, 3), dt)
        )
        frames = frames.astype(jnp.float32)
        return jnp.clip((frames + 1.0) * 127.5, 0.0, 255.0).astype(jnp.uint8)

    def render_jacobi_sharded(
        self, labels_u8: np.ndarray, mesh, sweeps: int = 3
    ) -> np.ndarray:
        """Jacobi decoding with the TIME axis sharded over ``mesh``'s
        "data" axis: one utterance spans every device.

        Same fixed-point semantics as :meth:`render_jacobi`; here each
        sweep's T independent generator forwards split T/n_data per device
        and the shifted windows halo-exchange between devices. Computation
        follows data — inputs are placed with a ``P("data")`` time
        sharding and the jitted sweep loop inherits it.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        cfg = self.config
        t = min(labels_u8.shape[0], cfg.max_frames)
        n_data = mesh.shape["data"]
        pad_t = (-t) % n_data
        labels = labels_u8[:t].astype(np.float32) / 127.5 - 1.0
        if pad_t:
            labels = np.pad(
                labels, ((0, pad_t), (0, 0), (0, 0), (0, 0))
            )
        has_prev = (np.arange(t + pad_t) > 0).astype(np.float32)

        shard_t = NamedSharding(mesh, P("data"))
        labels = jax.device_put(jnp.asarray(labels), shard_t)
        has_prev = jax.device_put(jnp.asarray(has_prev), shard_t)
        params = jax.device_put(self.params, NamedSharding(mesh, P()))

        fn = getattr(self, "_jacobi_sharded_cache", None)
        if fn is None:
            fn = jax.jit(self._jacobi_sharded_impl, static_argnums=(3,))
            object.__setattr__(self, "_jacobi_sharded_cache", fn)
        out = fn(params, labels, has_prev, max(int(sweeps), 1))
        return np.asarray(out)[:t]

    def _render_chunk_yuv_impl(self, params, labels, carry):
        """Like _render_chunk_impl but the frames leave as ONE flat uint8
        array of packed YUV420 planes — half the host-transfer bytes of
        RGB (ops/colorspace.py), and one device->host pull per chunk
        instead of three."""
        from text2video.ops.colorspace import rgb_norm_to_yuv420

        frames, carry = self._scan_chunk(params, labels, carry)
        y, u, v = rgb_norm_to_yuv420(frames)
        packed = jnp.concatenate(
            [y.reshape(-1), u.reshape(-1), v.reshape(-1)]
        )
        return packed, carry

    def _pack_coeff_planes(self, yq, uq, vq):
        """Flatten the three coefficient planes into ONE wire array:
        raw int8 coefficients, or (config.wire_packed) the per-block-
        shift bit-packed uint8 stream at ~67% of the bytes
        (ops/dct.py::pack_plane_shift)."""
        if self.config.wire_packed:
            from text2video.ops.dct import (
                W_AC_CHROMA,
                W_AC_LUMA,
                pack_plane_shift,
            )

            return jnp.concatenate([
                pack_plane_shift(yq, W_AC_LUMA),
                pack_plane_shift(uq, W_AC_CHROMA),
                pack_plane_shift(vq, W_AC_CHROMA),
            ])
        return jnp.concatenate(
            [yq.reshape(-1), uq.reshape(-1), vq.reshape(-1)]
        )

    def _render_chunk_dct_impl(self, params, labels, carry):
        """Like the YUV chunk but the planes leave as ONE flat array of
        zigzag-truncated quantized 8x8-DCT coefficients (ops/dct.py) —
        ~4x fewer wire bytes than YUV420 (bit-packed to ~67% of that
        again when config.wire_packed); the host dequantizes + IDCTs
        between pulls."""
        from text2video.ops.colorspace import rgb_norm_to_yuv420_float
        from text2video.ops.dct import encode_yuv

        cfg = self.config
        frames, carry = self._scan_chunk(params, labels, carry)
        y, u, v = rgb_norm_to_yuv420_float(frames)
        yq, uq, vq = encode_yuv(
            y, u, v,
            quality=cfg.wire_quality,
            k_luma=cfg.wire_k_luma,
            k_chroma=cfg.wire_k_chroma,
        )
        return self._pack_coeff_planes(yq, uq, vq), carry

    def _cached_jit(self, name: str, impl):
        fn = getattr(self, name, None)
        if fn is None:
            fn = jax.jit(impl, donate_argnums=(2,))
            object.__setattr__(self, name, fn)
        return fn

    @property
    def _render_chunk(self):
        return self._cached_jit("_render_chunk_cache", self._render_chunk_impl)

    @property
    def _render_chunk_yuv(self):
        return self._cached_jit(
            "_render_chunk_yuv_cache", self._render_chunk_yuv_impl
        )

    @property
    def _render_chunk_dct(self):
        return self._cached_jit(
            "_render_chunk_dct_cache", self._render_chunk_dct_impl
        )

    # ------------------------------------------------------------------

    def generate_device(self, labels_norm: jax.Array, params=None):
        """[B, T, H, W, 3] labels in [-1,1] -> list of [B, chunk, H, W, 3]
        uint8 device arrays (last chunk padded). No host transfer."""
        params = self.params if params is None else params
        b, t, h, w, _ = labels_norm.shape
        carry = self.init_carry(b, *self.target_hw(h, w))
        chunks = []
        for lo in range(0, t, self.time_bucket):
            hi = min(t, lo + self.time_bucket)
            pad = self.time_bucket - (hi - lo)
            chunk = labels_norm[:, lo:hi]
            if pad:
                chunk = jnp.pad(chunk, ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0)))
            frames_u8, carry = self._render_chunk(params, chunk, carry)
            chunks.append(frames_u8)
        return chunks

    def render(self, labels_u8: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8 label maps -> [T, H, W, 3] uint8 frames.

        Chunk transfers overlap the next chunk's compute (async dispatch).
        """
        t = min(labels_u8.shape[0], self.config.max_frames)
        labels = jnp.asarray(
            labels_u8[None, :t].astype(np.float32) / 127.5 - 1.0
        )
        chunks = self.generate_device(labels)
        host = [np.asarray(c[0]) for c in chunks]
        return np.concatenate(host, axis=0)[:t]

    def render_from_device_chunks(self, label_chunks, t: int) -> np.ndarray:
        """Render directly from on-device uint8 label chunks (the
        rasterizer's ``to_host=False`` output, chunk == time_bucket):
        labels never round-trip to the host on the pipeline's
        rasterize->render handoff.

        label_chunks: list of [time_bucket, H, W, 3] uint8 device arrays.
        Returns [t, H, W, 3] uint8 host frames.
        """
        if not label_chunks:
            raise ValueError("no label chunks")
        if self.config.decode_mode == "jacobi":
            want = min(t, self.config.max_frames)
            labels = (
                jnp.concatenate(list(label_chunks), axis=0)[:want]
                .astype(jnp.float32) / 127.5 - 1.0
            )
            frames = self.jacobi_device(labels, self.config.jacobi_sweeps)
            out = jnp.clip((frames + 1.0) * 127.5, 0.0, 255.0).astype(
                jnp.uint8
            )
            return np.asarray(out)
        label_chunks = self._normalize_chunks(label_chunks)
        h, w = label_chunks[0].shape[1:3]
        carry = self.init_carry(1, *self.target_hw(h, w))
        outs = []
        done = 0
        for chunk in label_chunks:
            if done >= self.config.max_frames:
                break
            labels = (
                chunk.astype(jnp.float32)[None] / 127.5 - 1.0
            )  # [1, C, H, W, 3]
            frames_u8, carry = self._render_chunk(self.params, labels, carry)
            outs.append(frames_u8)
            done += chunk.shape[0]
        t = min(t, self.config.max_frames, done)
        host = [np.asarray(c[0]) for c in outs]
        return np.concatenate(host, axis=0)[:t]

    def _normalize_chunks(self, label_chunks):
        """Make every chunk long enough for _scan_chunk's chunk-wide
        label-context assembly (>= n_frames_ctx-1 frames).

        The rasterizer emits uniform time_bucket chunks, so normally
        this is a no-op. A short FINAL chunk zero-pads at the end (the
        pad frames render but are discarded by the caller's ``t``
        truncation; the polluted carry is never used again). A short
        MID-STREAM chunk — only possible from external callers building
        their own chunk lists — falls back to concatenating the whole
        timeline and re-slicing into uniform time_bucket chunks, which
        preserves exact scan semantics at the cost of one extra
        device-side copy."""
        min_len = self.config.n_frames_ctx - 1
        chunks = list(label_chunks)
        if not chunks:
            raise ValueError("no label chunks")
        if all(c.shape[0] >= min_len for c in chunks[:-1]):
            last = chunks[-1]
            if last.shape[0] < min_len:
                pad = min_len - last.shape[0]
                chunks[-1] = jnp.pad(
                    last, ((0, pad), (0, 0), (0, 0), (0, 0))
                )
            return chunks
        flat = jnp.concatenate(chunks, axis=0)
        bucket = max(self.time_bucket, min_len)
        pad = (-flat.shape[0]) % bucket
        if pad:
            flat = jnp.pad(flat, ((0, pad), (0, 0), (0, 0), (0, 0)))
        return [
            flat[lo : lo + bucket] for lo in range(0, flat.shape[0], bucket)
        ]

    def _split_wire(self, arr: np.ndarray, c: int, n: int, h2: int, w2: int):
        """Split one pulled wire array back into its three per-plane
        arrays: DCT coefficients ([n, hb, wb, k] int8 per plane) for the
        "dct" format, uint8 pixel planes for "yuv420".

        arr: the flat packed chunk ([1, c, ...] planes ravelled in y/u/v
        order); c = frames in the chunk, n <= c frames wanted."""
        hc, wc = h2 // 2, w2 // 2
        if self.config.wire_format == "dct":
            kl, kc = self.config.wire_k_luma, self.config.wire_k_chroma
            hb, wb = -(-h2 // 8), -(-w2 // 8)
            hbc, wbc = -(-hc // 8), -(-wc // 8)
            if self.config.wire_packed:
                # Unpack the bit-packed stream back to plain int8
                # coefficient arrays (same domain as the raw wire, the
                # block shift folded back in) — downstream decode paths
                # (decode_plane_np, the native codec) see no difference.
                from text2video.ops.dct import (
                    W_AC_CHROMA,
                    W_AC_LUMA,
                    packed_plane_bytes,
                    unpack_plane_shift_np,
                )

                sy = packed_plane_bytes(c * hb * wb, kl, W_AC_LUMA)
                su = packed_plane_bytes(c * hbc * wbc, kc, W_AC_CHROMA)
                buf = arr.view(np.uint8)
                return (
                    unpack_plane_shift_np(
                        buf[:sy], (c, hb, wb, kl), W_AC_LUMA
                    )[:n],
                    unpack_plane_shift_np(
                        buf[sy : sy + su], (c, hbc, wbc, kc), W_AC_CHROMA
                    )[:n],
                    unpack_plane_shift_np(
                        buf[sy + su : sy + 2 * su],
                        (c, hbc, wbc, kc),
                        W_AC_CHROMA,
                    )[:n],
                )
            sy, su = c * hb * wb * kl, c * hbc * wbc * kc
            return (
                arr[:sy].reshape(c, hb, wb, kl)[:n],
                arr[sy : sy + su].reshape(c, hbc, wbc, kc)[:n],
                arr[sy + su : sy + 2 * su].reshape(c, hbc, wbc, kc)[:n],
            )
        sy, su = c * h2 * w2, c * hc * wc
        return (
            arr[:sy].reshape(c, h2, w2)[:n],
            arr[sy : sy + su].reshape(c, hc, wc)[:n],
            arr[sy + su : sy + 2 * su].reshape(c, hc, wc)[:n],
        )

    def _unpack_wire(self, arr: np.ndarray, c: int, n: int, h2: int, w2: int):
        """Split + decode one pulled wire array into (y, u, v) uint8
        planes (cropped; encode_plane 8-pads non-multiple-of-8 planes,
        e.g. the 540x960 chroma of a 1080p canvas)."""
        a, b, d = self._split_wire(arr, c, n, h2, w2)
        if self.config.wire_format != "dct":
            return a, b, d
        from text2video.ops.dct import decode_plane_np, quant_tables

        lq, cq = quant_tables(self.config.wire_quality)
        hc, wc = h2 // 2, w2 // 2
        return (
            decode_plane_np(a, lq)[..., :h2, :w2],
            decode_plane_np(b, cq)[..., :hc, :wc],
            decode_plane_np(d, cq)[..., :hc, :wc],
        )

    def render_stream_yuv(self, label_chunks, t: int, timer=None):
        """Stream-render on-device uint8 label chunks to per-chunk host
        YUV420 planes: yields (y [n,H,W], u [n,H/2,W/2], v [n,H/2,W/2])
        uint8 numpy arrays, n summing to ``t``.

        All chunk programs are dispatched up front (JAX async dispatch)
        with each chunk's output packed into ONE flat wire array, then
        chunks are pulled PROGRESSIVELY in order with serial
        ``np.asarray`` (each pull blocks until its own chunk's program
        ran; later chunks keep computing during the transfer), and
        unpacked/cropped on host. Before the pull loop every packed
        array gets a ``copy_to_host_async()`` — the copy stream is
        ordered, so chunk i+1's bytes move over the link while the host
        decodes chunk i instead of leaving the link idle. The wire
        format follows ``config.wire_format``: "yuv420" transfers uint8
        planes (half of RGB); "dct" (default) transfers zigzag-truncated
        quantized 8x8-DCT coefficients (~4x fewer bytes again,
        ops/dct.py), dequantized + IDCT'd per chunk on host. Serial
        whole-array pulls keep later chunks computing while earlier ones
        transfer, and the first chunk reaches the muxer early. ``timer``
        (a StageTimer) optionally records the render_pull /
        render_decode split.
        """
        h2, w2 = self.target_hw(*label_chunks[0].shape[1:3])
        for arr, c, n in self._stream_packed(label_chunks, t, timer):
            if timer:
                with timer.stage("render_decode"):
                    planes = self._unpack_wire(arr, c, n, h2, w2)
            else:
                planes = self._unpack_wire(arr, c, n, h2, w2)
            yield planes

    def render_stream_coeffs(self, label_chunks, t: int, timer=None):
        """Like :meth:`render_stream_yuv` but yields the RAW split
        coefficient arrays (yq [n,hb,wb,kl], uq, vq int8) per chunk,
        undecoded, together with the working dims: ((yq, uq, vq),
        (h2, w2)). For consumers that hand the wire bytes straight to
        the native codec (io/wire_native.py: fused coefficient->BGR
        decode, coefficient->JPEG assembly) — the host never
        materializes pixel planes on the transfer path. Requires
        ``config.wire_format == "dct"``.
        """
        if self.config.wire_format != "dct":
            raise ValueError("render_stream_coeffs requires the dct wire")
        h2, w2 = self.target_hw(*label_chunks[0].shape[1:3])
        for arr, c, n in self._stream_packed(label_chunks, t, timer):
            yield self._split_wire(arr, c, n, h2, w2), (h2, w2)

    def _encode_wire_impl(self, frames):
        """[C, H, W, 3] f32 frames in [-1,1] -> one flat packed wire
        array (dct coefficients or yuv420 planes, per config) — the
        encode half of _render_chunk_{dct,yuv}_impl for decode paths
        that produce frames outside the scan (Jacobi)."""
        if self.config.wire_format == "dct":
            from text2video.ops.colorspace import rgb_norm_to_yuv420_float
            from text2video.ops.dct import encode_yuv

            cfg = self.config
            y, u, v = rgb_norm_to_yuv420_float(frames[None])
            yq, uq, vq = encode_yuv(
                y, u, v,
                quality=cfg.wire_quality,
                k_luma=cfg.wire_k_luma,
                k_chroma=cfg.wire_k_chroma,
            )
            return self._pack_coeff_planes(yq, uq, vq)
        from text2video.ops.colorspace import rgb_norm_to_yuv420

        y, u, v = rgb_norm_to_yuv420(frames[None])
        return jnp.concatenate(
            [y.reshape(-1), u.reshape(-1), v.reshape(-1)]
        )

    @property
    def _encode_wire(self):
        fn = getattr(self, "_encode_wire_cache", None)
        if fn is None:
            fn = jax.jit(self._encode_wire_impl)
            object.__setattr__(self, "_encode_wire_cache", fn)
        return fn

    def _stream_packed(self, label_chunks, t: int, timer=None):
        """Shared streaming driver: dispatch every chunk program, start
        ordered async device->host copies, then pull progressively.
        Yields (flat wire array, chunk frames, wanted frames).

        decode_mode "scan" threads the autoregressive carry chunk to
        chunk; "jacobi" decodes the whole timeline with
        config.jacobi_sweeps batched sweeps first (render_jacobi
        docstring), then encodes the same wire chunks — the transfer
        path downstream is identical."""
        if not label_chunks:
            raise ValueError("no label chunks")
        use_dct = self.config.wire_format == "dct"
        h2, w2 = self.target_hw(*label_chunks[0].shape[1:3])

        def span(name):
            return timer.stage(name) if timer else contextlib.nullcontext()

        device_out = []
        done = 0
        if self.config.decode_mode == "jacobi":
            want = min(t, self.config.max_frames)
            labels = (
                jnp.concatenate(list(label_chunks), axis=0)[:want]
                .astype(jnp.float32) / 127.5 - 1.0
            )
            frames = self.jacobi_device(
                labels, self.config.jacobi_sweeps
            )  # [want, h2, w2, 3] f32
            bucket = label_chunks[0].shape[0]
            for lo in range(0, want, bucket):
                chunk = frames[lo : lo + bucket]
                pad = bucket - chunk.shape[0]
                if pad:
                    chunk = jnp.pad(
                        chunk, ((0, pad), (0, 0), (0, 0), (0, 0))
                    )
                device_out.append((self._encode_wire(chunk), bucket))
            done = want
        else:
            program = (
                self._render_chunk_dct if use_dct else self._render_chunk_yuv
            )
            carry = self.init_carry(1, h2, w2)
            for chunk in self._normalize_chunks(label_chunks):
                if done >= min(t, self.config.max_frames):
                    break
                labels = chunk.astype(jnp.float32)[None] / 127.5 - 1.0
                packed, carry = program(self.params, labels, carry)
                device_out.append((packed, chunk.shape[0]))
                done += chunk.shape[0]
        for packed, _ in device_out:
            packed.copy_to_host_async()
        rem = min(t, self.config.max_frames, done)
        for packed, c in device_out:
            n = min(c, rem)
            if n <= 0:
                break
            with span("render_pull"):
                arr = np.asarray(packed)
            yield arr, c, n
            rem -= n

    def render_many(self, labels_u8: np.ndarray, mesh=None) -> np.ndarray:
        """[B, T, H, W, 3] uint8 -> [B, T, H, W, 3] uint8 frames.

        Cross-utterance batch parallelism: with a mesh, the utterance axis
        shards over "data" and every scan step runs B/n_data generator
        forwards per device (SURVEY.md §2.5; the scaling story for a
        sequential model). Params are replicated.
        """
        labels = jnp.asarray(labels_u8)
        return self.render_many_device(labels, mesh=mesh)

    def render_many_device(self, labels_u8, mesh=None) -> np.ndarray:
        """Like :meth:`render_many` but takes [B, T, H, W, 3] uint8 labels
        already on device (e.g. stacked rasterizer chunks) — the label
        side never round-trips through the host."""
        b, t = labels_u8.shape[:2]
        t = min(t, self.config.max_frames)
        labels = labels_u8[:, :t].astype(jnp.float32) / 127.5 - 1.0
        params = self.params
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sharding = NamedSharding(mesh, P("data"))
            labels = jax.device_put(labels, sharding)
            # Replicate params locally for this call — never mutate the
            # renderer's own params as a render side effect.
            params = jax.device_put(params, NamedSharding(mesh, P()))
        chunks = self.generate_device(labels, params=params)
        return np.concatenate([np.asarray(c) for c in chunks], axis=1)[:, :t]
