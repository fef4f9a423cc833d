"""VGG19 feature extractor for the perceptual loss.

The reference's vid2vid training objective includes a VGG19 perceptual
term (standard in the pix2pixHD/vid2vid family the fork modifies;
SURVEY.md §2.3). This is a from-scratch JAX implementation of the VGG19
convolutional stack that returns the relu{1..5}_1 activations.

Weights: pretrained VGG weights cannot be downloaded in this environment
(zero egress). ``load_params`` reads a ``.npz`` of conv kernels/biases if
the user provides one (keys ``conv{i}_{j}/kernel`` HWIO, ``.../bias``);
otherwise ``init_params`` gives a fixed-seed random network. Random-filter
perceptual losses are a documented, usable fallback ("A Powerful Generative
Model Using Random Weights", He et al. 2016) — the loss still measures
multi-scale structural agreement, just less semantically weighted.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from text2video.models.layers import Conv, Module, Scope, max_pool2x, module

# (block, convs-in-block, channels) for VGG19's five conv stages.
_STAGES: Sequence[Tuple[int, int, int]] = (
    (1, 2, 64),
    (2, 2, 128),
    (3, 4, 256),
    (4, 4, 512),
    (5, 4, 512),
)

# ImageNet normalisation (inputs arrive in [-1, 1]).
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


@module
class VGG19Features(Module):
    """Returns [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1]."""

    dtype: Any = jnp.bfloat16

    def forward(self, s: Scope, x: jax.Array) -> List[jax.Array]:
        # [-1,1] -> ImageNet-normalised.
        x = (x.astype(jnp.float32) + 1.0) * 0.5
        x = (x - _MEAN) / _STD
        x = x.astype(self.dtype)
        feats: List[jax.Array] = []
        for block, n_convs, ch in _STAGES:
            for j in range(1, n_convs + 1):
                conv = Conv(ch, padding="SAME", dtype=self.dtype)
                x = jax.nn.relu(s(conv, x, name=f"conv{block}_{j}"))
                if j == 1:
                    feats.append(x)
            if block < 5:
                x = max_pool2x(x)
        return feats


def init_params(dtype=jnp.bfloat16, seed: int = 0) -> Dict:
    model = VGG19Features(dtype=dtype)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return model.init(jax.random.PRNGKey(seed), x)["params"]


def load_params(npz_path: str, dtype=jnp.bfloat16) -> Dict:
    """Load conv weights from an .npz (kernel HWIO float32). Any layer
    missing from the file keeps its random init."""
    params = jax.tree.map(np.asarray, init_params(dtype=dtype))
    data = np.load(npz_path)
    for block, n_convs, _ in _STAGES:
        for j in range(1, n_convs + 1):
            name = f"conv{block}_{j}"
            if f"{name}/kernel" in data:
                params[name]["kernel"] = data[f"{name}/kernel"].astype(
                    np.float32
                )
                params[name]["bias"] = data[f"{name}/bias"].astype(np.float32)
    return jax.tree.map(jnp.asarray, params)
