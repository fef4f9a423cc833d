"""text2video — text-driven talking-head video synthesis in JAX.

A brand-new JAX/XLA framework with the capabilities of the reference
Text2Video system (ICASSP 2022, sibozhang/Text2Video): text (English or
Mandarin) or real audio in, photorealistic talking-head video with
synchronized audio out.

Pipeline (reference: text2video_tts.sh / text2video_audio.sh /
text2video_tts_chinese.sh):

    text --(TTS | real audio)--> waveform
         --(forced alignment | ASR timestamping)--> per-phoneme/pinyin frames
         --(phoneme-pose dictionary gather + interpolation + smoothing)--> pose tracks
         --(batched skeleton rasterization)--> pose label maps
         --(pose2frame GAN, jitted + sharded over a device mesh)--> frames
         --(muxing)--> MP4/AVI with audio

Unlike the reference (a pipeline of scripts glued by the filesystem), this is
an in-memory typed pipeline: stages pass arrays, the per-frame hot loops are
single jitted XLA programs over whole utterances, and multi-device scaling is
expressed with jax.sharding meshes.
"""

__version__ = "0.1.0"

from text2video.config import PersonProfile, PipelineConfig, get_profile

__all__ = [
    "PersonProfile",
    "PipelineConfig",
    "get_profile",
    "__version__",
]
