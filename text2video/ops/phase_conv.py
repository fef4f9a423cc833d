"""Exact phase-form (polyphase) convolutions for the generator tail.

Parity/motivation: the reference renderer's decoder (vid2vid fork,
SURVEY.md §2.3) upsamples with stride-2 transposed convs and finishes
with full-resolution narrow-output heads. Our equivalents
(``layers.Upsample`` = nearest-resize + 3x3 conv; one merged 7x7 heads
conv, ``models/generator.py``) run at full resolution with narrow
outputs (6 or 64 channels), which matrix units with a wide output tile
pad heavily. Whether the phase form wins on the GPU is not yet
measured; the plain form is the float32 reference either way.

This module reformulates both ops EXACTLY (same math, same parameters,
new schedule) at the coarse resolution:

  * ``nearest-up(2x) -> reflect-pad(1) -> 3x3 VALID conv`` over a
    [h, w, Cin] input touches at most a 2x2 window of coarse pixels per
    output pixel. Computing all four output phases (the 2x2 polyphase
    decomposition of the full-res output) as ONE 2x2-window conv with
    4*Cout stacked outputs quarters M, keeps K, and lifts N to 4*Cout,
    and never materialises the 2x resized intermediate.
  * a full-res ``reflect-pad(3) -> 7x7 conv`` whose input is itself a
    phase tensor becomes a 4x4-window conv over the phase tensor with
    4*Cout outputs (24 output channels at half resolution instead of 6
    at full resolution).

Both directions are *weight reparameterisations*: the phase kernels are
built on the fly from the ORIGINAL kernel parameters, so checkpoints,
param trees, and training all stay unchanged, and equality with the
plain path is tested to float tolerance (tests/test_phase_conv.py).

Phase layout convention: a phase tensor P of shape [B, h, w, 4*C]
represents a full-res map f of shape [B, 2h, 2w, C] with

    f[:, 2*i + pr, 2*j + pc, c] == P[:, i, j, (2*pr + pc) * C + c]

(pr/pc = row/col phase; channel blocks ordered p = 2*pr + pc).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_DN = lax.conv_dimension_numbers(
    (1, 1, 1, 1), (1, 1, 1, 1), ("NHWC", "HWIO", "NHWC")
)


def depth_to_space2(p: jax.Array) -> jax.Array:
    """[B, h, w, 4*C] phase tensor -> [B, 2h, 2w, C] full-res map."""
    b, h, w, c4 = p.shape
    c = c4 // 4
    p = p.reshape(b, h, w, 2, 2, c)
    p = p.transpose(0, 1, 3, 2, 4, 5)
    return p.reshape(b, 2 * h, 2 * w, c)


def space_to_depth2(f: jax.Array) -> jax.Array:
    """[B, 2h, 2w, C] -> [B, h, w, 4*C] (inverse of depth_to_space2)."""
    b, hh, ww, c = f.shape
    f = f.reshape(b, hh // 2, 2, ww // 2, 2, c)
    f = f.transpose(0, 1, 3, 2, 4, 5)
    return f.reshape(b, hh // 2, ww // 2, 4 * c)


# ---------------------------------------------------------------------
# nearest-up(2x) + reflect-pad(1) + 3x3 conv, in phase form
# ---------------------------------------------------------------------

# S[pr][a] = the set of 3x3 kernel row offsets o that coarse tap a
# contributes to output row-phase pr. Derivation: output full row
# 2i+pr reads upsampled rows 2i+pr-1 .. 2i+pr+1; nearest upsampling maps
# full row r to coarse row r//2, so
#   pr=0: offsets (0,1,2) read coarse rows (i-1, i, i) -> a=0:{0}, a=1:{1,2}
#   pr=1: offsets read coarse rows (i, i, i+1)         -> a=0:{0,1}, a=1:{2}
# Columns are identical by separability of the window structure.
_UP_MAP = np.zeros((2, 2, 3), np.float32)  # [phase, tap a, offset o]
_UP_MAP[0, 0, 0] = 1.0
_UP_MAP[0, 1, 1] = _UP_MAP[0, 1, 2] = 1.0
_UP_MAP[1, 0, 0] = _UP_MAP[1, 0, 1] = 1.0
_UP_MAP[1, 1, 2] = 1.0


def build_up_kernel(k3: jax.Array) -> jax.Array:
    """[3, 3, Cin, Cout] -> [2, 2, Cin, 4*Cout] phase window kernel."""
    m = jnp.asarray(_UP_MAP, k3.dtype)
    # kp[a, b, ci, pr, pc, co] = sum_{or,oc} m[pr,a,or] m[pc,b,oc] k3[or,oc,ci,co]
    kp = jnp.einsum("pao,qbt,otic->abipqc", m, m, k3)
    kh, kw, cin = kp.shape[:3]
    return kp.reshape(kh, kw, cin, 4 * k3.shape[3])


def upsample2x_conv_phase(x: jax.Array, k3: jax.Array) -> jax.Array:
    """Exact ``nearest-up(2x); reflect-pad(1); 3x3 VALID conv`` of x with
    kernel ``k3`` [3, 3, Cin, Cout], returned as a PHASE tensor
    [B, h, w, 4*Cout] (no bias, no cast — callers handle both).

    Border rule: reflect-padding the 2x-upsampled map by 1 duplicates the
    first/last coarse row/col, i.e. EDGE padding of the coarse input.
    """
    h, w = x.shape[1:3]
    kp = build_up_kernel(k3).astype(x.dtype)
    xpad = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    win = lax.conv_general_dilated(
        xpad, kp, (1, 1), "VALID", dimension_numbers=_DN
    )  # [B, h+1, w+1, 4*Cout]
    return _align_phases(win, h, w)


def _align_phases(win: jax.Array, h: int, w: int) -> jax.Array:
    """Window-conv output [B, h+1, w+1, 4*C] -> aligned phase tensor
    [B, h, w, 4*C]: output phase (pr, pc) at coarse (i, j) is the window
    at (i + pr, j + pc)."""
    c = win.shape[-1] // 4
    blocks = []
    for pr in (0, 1):
        for pc in (0, 1):
            p = 2 * pr + pc
            blocks.append(
                win[:, pr : h + pr, pc : w + pc, p * c : (p + 1) * c]
            )
    return jnp.concatenate(blocks, axis=-1)


# ---------------------------------------------------------------------
# reflect-pad(3) + 7x7 conv over a phase-form input, in phase form
# ---------------------------------------------------------------------

def build_head_kernel(k7: jax.Array) -> jax.Array:
    """[7, 7, Cin, Cout] -> [4, 4, 4*Cin, 4*Cout] phase window kernel.

    Entry [a, b, (pi_r, pi_c, ci), (po_r, po_c, co)] maps to
    k7[2a + pi_r + po_r - 1, 2b + pi_c + po_c - 1, ci, co]
    (out-of-range rows/cols are zero): with the output-phase window
    starting at coarse row i - 2 + po_r, the coarse tap a at input phase
    pi_r holds full-res row 2(i - 2 + po_r + a) + pi_r, whose offset into
    the reflect-padded 7x7 receptive field of output row 2i + po_r is
    2a + pi_r + po_r - 1.
    """
    cin, cout = k7.shape[2], k7.shape[3]
    kpad = jnp.pad(k7, ((1, 1), (1, 1), (0, 0), (0, 0)))  # idx+1 in [0,9)
    a = np.arange(4)
    pi = np.arange(2)
    po = np.arange(2)
    # idx[a, pi, po] = 2a + pi + po - 1 + 1 (into the padded axis), with
    # anything outside [0, 8] clamped onto a zero pad row.
    idx = 2 * a[:, None, None] + pi[None, :, None] + po[None, None, :]
    idx = np.clip(idx, 0, 8)
    idx = jnp.asarray(idx)
    # Gather rows then cols: kp[a,pi_r,po_r, b,pi_c,po_c, ci, co]
    kp = kpad[idx]  # [4,2,2, 9, ci, co]
    kp = jnp.moveaxis(kp, 3, 0)[idx]  # [4,2,2, 4,2,2, ci, co]
    kp = jnp.moveaxis(kp, (0, 1, 2), (3, 4, 5))  # back to [a,pr.. b,pc..]
    # Reorder to [a, b, pi_r, pi_c, ci, po_r, po_c, co] then flatten.
    kp = kp.transpose(0, 3, 1, 4, 6, 2, 5, 7)
    return kp.reshape(4, 4, 4 * cin, 4 * cout)


def _head_pad_axis(p: jax.Array, axis: int, phase_axis_stride: int,
                   c: int) -> jax.Array:
    """Pad a phase tensor by 2 along ``axis`` with the phase-form image
    of a full-res reflect-pad(3).

    With P[i, pr] holding full row 2i+pr and fpad[-k] = f[k]:
      Ppad[-1] = (pr0 <- f[2]  = P[1, pr1=0-block's pr=0 ... ]) —
        concretely: pr=0 block <- P[1, pr=0], pr=1 block <- P[0, pr=1]
      Ppad[-2] = pr=0 block <- P[2, pr=0] (zero-tap, filler),
                 pr=1 block <- P[1, pr=1]
      Ppad[h]   = pr=0 <- P[h-1, pr=0], pr=1 <- P[h-2, pr=1]
      Ppad[h+1] = pr=0 <- P[h-2, pr=0], pr=1 <- P[h-3, pr=1] (filler)

    ``phase_axis_stride``: how many channel-blocks a row-phase step spans
    (2*c for the row axis, c for the col axis — layout p = 2*pr + pc).
    """
    n = p.shape[axis]

    def take(i):
        i = int(np.clip(i, 0, n - 1))
        return lax.slice_in_dim(p, i, i + 1, axis=axis)

    cdim = p.shape[-1]
    nblk = cdim // (2 * phase_axis_stride)  # pairs of (pr=0, pr=1) blocks

    def mix(i0, i1):
        """One pad row: phase-0 blocks from row i0, phase-1 from i1."""
        a, b = take(i0), take(i1)
        parts = []
        for k in range(nblk):
            lo = k * 2 * phase_axis_stride
            parts.append(a[..., lo : lo + phase_axis_stride])
            parts.append(
                b[..., lo + phase_axis_stride : lo + 2 * phase_axis_stride]
            )
        return jnp.concatenate(parts, axis=-1)

    top = [mix(2, 1), mix(1, 0)]          # Ppad[-2], Ppad[-1]
    bot = [mix(n - 1, n - 2), mix(n - 2, n - 3)]  # Ppad[n], Ppad[n+1]
    return jnp.concatenate(top + [p] + bot, axis=axis)


def head_conv_phase(
    p: jax.Array, k7: jax.Array, emit_phase: bool = False
) -> jax.Array:
    """Exact ``reflect-pad(3); 7x7 VALID conv`` of the full-res map
    represented by phase tensor ``p`` [B, h, w, 4*Cin] with kernel ``k7``
    [7, 7, Cin, Cout]; returns the FULL-RES output [B, 2h, 2w, Cout]
    (no bias, no cast), or the aligned PHASE tensor [B, h, w, 4*Cout]
    when ``emit_phase`` (for a phase-aware consumer, e.g. the stem ->
    first-downsample chain: the full-res map is then never built).
    """
    h, w = p.shape[1:3]
    cin, cout = k7.shape[2], k7.shape[3]
    kp = build_head_kernel(k7).astype(p.dtype)
    # Row-axis phase stride: channel layout (2*pr + pc)*C + c, so a row
    # phase step spans 2*C channels and a col step spans C. The column
    # pad needs per-(pr)-block col-phase mixing: stride C with the
    # (pc=0, pc=1) pair repeating twice.
    ppad = _head_pad_axis(p, 1, 2 * cin, cin)
    ppad = _head_pad_axis(ppad, 2, cin, cin)
    win = lax.conv_general_dilated(
        ppad, kp, (1, 1), "VALID", dimension_numbers=_DN
    )  # [B, h+1, w+1, 4*Cout]
    aligned = _align_phases(win, h, w)
    return aligned if emit_phase else depth_to_space2(aligned)


# ---------------------------------------------------------------------
# reflect-pad(1) + 3x3 stride-2 conv over a phase-form input
# ---------------------------------------------------------------------

def build_down_kernel(k3: jax.Array) -> jax.Array:
    """[3, 3, Cin, Cout] -> [2, 2, 4*Cin, Cout] phase window kernel for a
    stride-2 conv consuming a phase tensor.

    The stride-2 output at coarse (i, j) reads full-res rows
    2i-1 .. 2i+1 (after reflect-pad(1)). Coarse tap a in a 2x2 window
    anchored at coarse row i-1 holds, at input phase pi_r, full row
    2(i-1+a) + pi_r = 2i + (2a + pi_r - 2), i.e. kernel row
    r = 2a + pi_r - 1 (r = -1 for (a=0, pi_r=0): zero weight).
    """
    cin, cout = k3.shape[2], k3.shape[3]
    kpad = jnp.pad(k3, ((1, 0), (1, 0), (0, 0), (0, 0)))  # idx r+1 in [0,4)
    a = np.arange(2)
    pi = np.arange(2)
    idx = jnp.asarray(2 * a[:, None] + pi[None, :])  # [a, pi] in [0, 3]
    kp = kpad[idx]  # [2, 2, 4, cin, cout]   (a, pi_r, padded col, ci, co)
    kp = jnp.moveaxis(kp, 2, 0)[idx]  # [2, 2, 2, 2, cin, cout]
    kp = jnp.moveaxis(kp, (0, 1), (2, 3))  # [a, pi_r, b, pi_c, ci, co]
    kp = kp.transpose(0, 2, 1, 3, 4, 5)  # [a, b, pi_r, pi_c, ci, co]
    return kp.reshape(2, 2, 4 * cin, cout)


def down2x_conv_phase(p: jax.Array, k3: jax.Array) -> jax.Array:
    """Exact ``reflect-pad(1); 3x3 stride-2 VALID conv`` of the full-res
    map represented by phase tensor ``p`` [B, h, w, 4*Cin] with kernel
    ``k3`` [3, 3, Cin, Cout]; returns [B, h, w, Cout] (no bias, no cast).

    Border rule: the stride-2 output only ever reads one pad row/col at
    the top/left; full-res reflect-pad(1) there is f[-1] = f[1], which is
    the pr=1 block of coarse row 0 — exactly what EDGE-padding the phase
    tensor supplies (the pr=0 block of the pad row has zero weight).
    """
    kp = build_down_kernel(k3).astype(p.dtype)
    ppad = jnp.pad(p, ((0, 0), (1, 0), (1, 0), (0, 0)), mode="edge")
    return lax.conv_general_dilated(
        ppad, kp, (1, 1), "VALID", dimension_numbers=_DN
    )  # [B, h, w, Cout]
