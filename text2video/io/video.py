"""Frame/audio muxing: frames -> video file with a synchronized track.

Replaces the reference's L7 muxer (reference:
*phoneme_data/VidTIMIT/fadg0/image2video_real.py — cv2.VideoWriter MP4V at
fps=25, then moviepy/ffmpeg re-mux with audio). This environment has no
ffmpeg binary, so both containers are written from scratch:

  * :func:`write_video` — MJPEG samples in an ISO-BMFF MP4 (io/mp4.py),
    the reference's first muxing stage. JPEG is encoded once per frame;
    the container stage is pure bookkeeping (the earlier cv2 ``mp4v``
    writer paid a full pixel re-encode per frame).
  * :func:`write_avi_with_audio` — a from-scratch RIFF/AVI muxer
    interleaving MJPEG frames (cv2 JPEG encode) with 16-bit PCM audio.
    Plays in ffmpeg/VLC/browsers; no external tools.
  * :func:`mux` — writes mp4+wav and, when audio is given, the AVI; uses
    the ffmpeg binary for an ``_audio.mp4`` when one is on PATH.

The streamed-DCT path (:class:`StreamingMuxer`.add_coeffs) never touches
pixels at all: the native codec entropy-codes the wire coefficients into
JPEG bytes (io/wire_native.py) and both containers stream-copy those
bytes — no IDCT, no re-encode, no quality loss beyond the wire quant.
That path needs no cv2; the pixel paths import it where they run.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from typing import List, Optional

import numpy as np

from text2video.frontend.audio import save_wav
from text2video.io.mp4 import Mp4Writer


def write_video(
    frames: np.ndarray, path: str, fps: float = 25.0,
    jpeg_quality: int = 95,
) -> None:
    """frames: [T, H, W, 3] uint8 RGB -> .mp4 (MJPEG samples, no audio)."""
    import cv2

    t, h, w, _ = frames.shape
    with Mp4Writer(path, w, h, fps) as writer:
        for i in range(t):
            writer.add_jpeg(
                _encode_jpeg(
                    cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR), jpeg_quality
                )
            )


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def _encode_jpeg(bgr: np.ndarray, quality: int) -> bytes:
    import cv2

    ok, buf = cv2.imencode(
        ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality]
    )
    if not ok:
        raise RuntimeError("JPEG encode failed")
    return bytes(buf)


def write_avi_with_audio(
    frames: np.ndarray,
    audio: Optional[np.ndarray],
    path: str,
    fps: float = 25.0,
    sample_rate: int = 16000,
    jpeg_quality: int = 95,
) -> None:
    """Mux [T,H,W,3] uint8 RGB frames + mono float PCM into an AVI.

    MJPEG video stream '00dc' interleaved with 16-bit PCM chunks '01wb',
    one audio slice per frame, plus an idx1 index.
    """
    import cv2

    t, h, w, _ = frames.shape
    jpegs = [
        _encode_jpeg(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR), jpeg_quality)
        for i in range(t)
    ]
    pcm = None
    if audio is not None and len(audio) > 0:
        pcm = (np.clip(audio, -1, 1) * 32767.0).astype("<i2")
    _assemble_avi(jpegs, pcm, path, fps, sample_rate, w, h)


def _assemble_avi(
    jpegs: List[bytes],
    pcm: Optional[np.ndarray],
    path: str,
    fps: float,
    sample_rate: int,
    w: int,
    h: int,
) -> None:
    """Assemble the RIFF/AVI container from pre-encoded JPEG frames and
    (optionally) int16 PCM (padded here to the video duration)."""
    t = len(jpegs)
    has_audio = pcm is not None and len(pcm) > 0
    if has_audio:
        total_needed = int(round(t / fps * sample_rate))
        if len(pcm) < total_needed:
            pcm = np.concatenate(
                [pcm, np.zeros(total_needed - len(pcm), "<i2")]
            )

    # movi payload + idx1 entries (offsets relative to 'movi' fourcc).
    movi = b"movi"
    idx = b""
    audio_pos = 0
    for i in range(t):
        off = len(movi)
        data = _chunk(b"00dc", jpegs[i])
        movi += data
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(jpegs[i]))
        if has_audio:
            end = int(round((i + 1) / fps * sample_rate))
            sl = pcm[audio_pos:end].tobytes()
            audio_pos = end
            off = len(movi)
            movi += _chunk(b"01wb", sl)
            idx += b"01wb" + struct.pack("<III", 0x10, off, len(sl))

    max_jpeg = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I",
        int(1_000_000 / fps),      # microseconds per frame
        int(max_jpeg * fps),       # max bytes/sec (approx)
        0,                         # padding granularity
        0x110,                     # HASINDEX | ISINTERLEAVED
        t,                         # total frames
        0,                         # initial frames
        2 if has_audio else 1,     # streams
        max_jpeg,                  # suggested buffer
        w, h, 0, 0, 0, 0,
    )
    strh_v = struct.pack(
        "<4s4sIHHIIIIIIII4H",
        b"vids", b"MJPG", 0, 0, 0, 0,
        1000, int(fps * 1000),     # scale, rate
        0, t, max_jpeg, 10000, 0,
        0, 0, np.uint16(w), np.uint16(h),
    )
    strf_v = struct.pack(
        "<IiiHH4sIiiII",
        40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0,
    )
    strl_v = _list(b"strl", _chunk(b"strh", strh_v) + _chunk(b"strf", strf_v))

    hdrl_payload = _chunk(b"avih", avih) + strl_v
    if has_audio:
        block_align = 2  # mono 16-bit
        strh_a = struct.pack(
            "<4s4sIHHIIIIIIII4H",
            b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0,
            1, sample_rate,        # scale, rate -> samples/sec
            0, len(pcm), sample_rate * block_align, 0xFFFFFFFF,
            block_align, 0, 0, 0, 0,
        )
        strf_a = struct.pack(
            "<HHIIHH",
            1,                     # WAVE_FORMAT_PCM
            1,                     # channels
            sample_rate,
            sample_rate * block_align,
            block_align,
            16,                    # bits/sample
        )
        hdrl_payload += _list(
            b"strl", _chunk(b"strh", strh_a) + _chunk(b"strf", strf_a)
        )

    body = (
        _list(b"hdrl", hdrl_payload)
        + _list(b"movi", movi[4:])
        + _chunk(b"idx1", idx)
    )
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body)


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


def mux(
    frames: np.ndarray,
    audio: Optional[np.ndarray],
    out_base: str,
    fps: float = 25.0,
    sample_rate: int = 16000,
) -> List[str]:
    """Write all applicable containers for ``out_base`` (no extension).

    Returns the list of files written: always ``.mp4`` (video-only via
    cv2, as the reference's first muxing stage) and, with audio, ``.wav``
    plus an audio-bearing container — ``_audio.mp4`` written alongside
    when ffmpeg exists, otherwise (or when ffmpeg fails, e.g. no aac
    encoder in the build) the self-contained ``.avi`` mux.
    """
    written: List[str] = []
    mp4 = out_base + ".mp4"
    write_video(frames, mp4, fps)
    written.append(mp4)
    if audio is None or len(audio) == 0:
        return written
    wav = out_base + ".wav"
    save_wav(wav, audio, sample_rate)
    written.append(wav)
    ff = _ffmpeg()
    if ff is not None:
        muxed = out_base + "_audio.mp4"
        try:
            subprocess.run(
                [ff, "-y", "-i", mp4, "-i", wav, "-c:v", "copy",
                 "-c:a", "aac", muxed],
                check=True,
                capture_output=True,
            )
            written.append(muxed)
            return written
        except subprocess.CalledProcessError:
            pass  # fall through to the self-contained AVI mux
    avi = out_base + ".avi"
    write_avi_with_audio(
        frames, audio, avi, fps=fps, sample_rate=sample_rate
    )
    written.append(avi)
    return written


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """[n,H,W] + 2x[n,H/2,W/2] uint8 planes -> [n,H,W,3] uint8 BGR via
    cv2's I420 conversion (inverse of ops/colorspace.rgb_norm_to_yuv420)."""
    import cv2

    n, h, w = y.shape
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        i420 = np.concatenate(
            [y[i].reshape(-1, w), u[i].reshape(-1, w), v[i].reshape(-1, w)]
        )
        out[i] = cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420)
    return out


class StreamingMuxer:
    """Incremental mux: frames arrive per chunk (as YUV420 planes straight
    off the device) while the renderer is still computing later chunks;
    a worker thread converts + encodes them off the transfer-critical
    path. ``close()`` finalizes the same set of outputs as :func:`mux`.

    This is what makes end-to-end latency max(compute, transfer, encode)
    instead of their sum — the reference's muxer only starts after every
    frame is on disk (reference: text2video_tts.sh:45-48).
    """

    def __init__(
        self,
        out_base: str,
        width: int,
        height: int,
        fps: float = 25.0,
        sample_rate: int = 16000,
        audio: Optional[np.ndarray] = None,
        jpeg_quality: int = 95,
        wire_quality: int = 80,
    ):
        import queue
        import threading

        self.out_base = out_base
        self.fps = fps
        self.sample_rate = sample_rate
        self.wh = (width, height)
        self.audio = audio
        self.jpeg_quality = jpeg_quality
        self.wire_quality = wire_quality
        self.has_audio = audio is not None and len(audio) > 0
        self.mp4 = out_base + ".mp4"
        self.writer = Mp4Writer(self.mp4, width, height, fps)
        self.jpegs: List[bytes] = []  # for the AVI fallback container
        self.n_frames = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=4)
        self._err: List[BaseException] = []
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                kind, a, b, c = item
                if kind == "yuv":
                    for bgr in yuv420_to_bgr(a, b, c):
                        jpeg = _encode_jpeg(bgr, self.jpeg_quality)
                        self.writer.add_jpeg(jpeg)
                        if self.has_audio:
                            self.jpegs.append(jpeg)
                else:  # "dct": raw wire coefficients, native codec
                    from text2video.io import wire_native

                    w, h = self.wh
                    # JPEGs assemble straight from the quantized
                    # coefficients — entropy coding only; the MP4 and the
                    # AVI both stream-copy the same bytes. No IDCT, no
                    # pixel re-encode anywhere on this path.
                    jpegs = wire_native.to_jpegs(
                        a, b, c, h, w, quality=self.wire_quality
                    )
                    for jpeg in jpegs:
                        self.writer.add_jpeg(jpeg)
                    if self.has_audio:
                        self.jpegs.extend(jpegs)
            except BaseException as e:  # surfaced in close()
                self._err.append(e)

    def add_yuv(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        self.n_frames += y.shape[0]
        self._q.put(("yuv", y, u, v))

    def add_coeffs(
        self, yq: np.ndarray, uq: np.ndarray, vq: np.ndarray
    ) -> None:
        """Enqueue one chunk of raw truncated-DCT wire coefficients
        (render.py::render_stream_coeffs output); the worker thread runs
        the native codec (io/wire_native.py) for both containers."""
        self.n_frames += yq.shape[0]
        self._q.put(("dct", yq, uq, vq))

    def close(self) -> List[str]:
        self._q.put(None)
        self._thread.join()
        self.writer.close()
        if self._err:
            raise self._err[0]
        written = [self.mp4]
        if not self.has_audio:
            return written
        wav = self.out_base + ".wav"
        save_wav(wav, self.audio, self.sample_rate)
        written.append(wav)
        ff = _ffmpeg()
        if ff is not None:
            muxed = self.out_base + "_audio.mp4"
            try:
                subprocess.run(
                    [ff, "-y", "-i", self.mp4, "-i", wav, "-c:v", "copy",
                     "-c:a", "aac", muxed],
                    check=True,
                    capture_output=True,
                )
                written.append(muxed)
                return written
            except subprocess.CalledProcessError:
                pass
        avi = self.out_base + ".avi"
        pcm = (np.clip(self.audio, -1, 1) * 32767.0).astype("<i2")
        _assemble_avi(
            self.jpegs, pcm, avi, self.fps, self.sample_rate, *self.wh
        )
        written.append(avi)
        return written
