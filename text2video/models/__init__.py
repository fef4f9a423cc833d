"""Neural renderer model family (pose2frame GAN) in plain JAX.

Capability parity with the reference's external vid2vid fork
(SURVEY.md §2.3): composite flow-warped generator, multiscale / temporal /
face discriminators, and the vid2vid loss family. Only the generator is
imported here; the training-only networks live in
``models.discriminator`` and ``models.vgg``.
"""

from text2video.models.generator import CompositeGenerator

__all__ = ["CompositeGenerator"]
