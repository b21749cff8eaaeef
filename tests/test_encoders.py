"""Audio encoder round-trip tests (VERDICT round 1, item 1).

The reference encodes with ``lame_encode_buffer_float`` and a +/-32768
pre-scale (src/web/mp3encoder.cxx:64-72); this framework binds
``lame_encode_buffer_ieee_float`` whose convention is +/-1.0 full scale.
These tests pin the amplitude convention by round-tripping a known sine
through the encoder and LAME's own hip decoder: the decoded waveform must
come back at the input amplitude (within codec tolerance), with a clipping
fraction of ~zero. A 32768 pre-scale bug turns a 0.25 sine into a
full-scale square wave — caught immediately here.
"""

import ctypes

import numpy as np
import pytest

from webradio.web import encoders

pytestmark = pytest.mark.skipif(
    not encoders.lame_available(), reason="libmp3lame not available"
)


def _hip_decode(mp3_bytes: bytes) -> np.ndarray:
    """Decode an MP3 byte stream to float mono (+/-1.0) via LAME's hip API.

    hip_decode1 emits at most one 1152-sample frame per call, so the stream
    is fed in sub-frame chunks (one frame is ~130 bytes at VBR minimum).
    """
    lame = encoders._LAME
    lame.hip_decode_init.restype = ctypes.c_void_p
    lame.hip_decode1.restype = ctypes.c_int
    lame.hip_decode1.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_short), ctypes.POINTER(ctypes.c_short),
    ]
    hip = ctypes.c_void_p(lame.hip_decode_init())
    try:
        out = []
        cap = 1 << 16
        pcm_l = (ctypes.c_short * cap)()
        pcm_r = (ctypes.c_short * cap)()
        for i in range(0, len(mp3_bytes), 32):
            chunk = mp3_bytes[i:i + 32]
            n = lame.hip_decode1(hip, chunk, len(chunk), pcm_l, pcm_r)
            if n > 0:
                out.append(np.ctypeslib.as_array(pcm_l)[:n].copy())
        if not out:
            return np.zeros(0, np.float32)
        return np.concatenate(out).astype(np.float32) / 32768.0
    finally:
        lame.hip_decode_exit(hip)


def _flush(enc: encoders.Mp3Encoder) -> bytes:
    lame = encoders._LAME
    out = ctypes.create_string_buffer(65536)
    n = lame.lame_encode_flush(enc._gf, out, 65536)
    return out.raw[:n] if n > 0 else b""


def test_mp3_roundtrip_amplitude():
    """A 0.25-amplitude sine must come back at ~0.25, not hard-clipped."""
    sr = 48_000
    amp = 0.25
    t = np.arange(sr, dtype=np.float64)  # 1 second
    x = (amp * np.sin(2 * np.pi * 1000.0 * t / sr)).astype(np.float32)
    enc = encoders.Mp3Encoder(sr)
    data = b""
    for i in range(0, len(x), 4096):
        data += enc.encode(x[i:i + 4096])
    data += _flush(enc)
    enc.close()
    assert len(data) > 1000
    y = _hip_decode(data)
    assert len(y) > sr // 2
    # skip codec warm-up/padding at both ends
    core = y[2000:-2000]
    peak = np.abs(core).max()
    # amplitude within ~1 dB of the input
    assert amp * 0.85 < peak < amp * 1.15, f"decoded peak {peak} vs input {amp}"
    # clipping fraction ~ 0: nothing near full scale
    clipped = np.mean(np.abs(core) > 0.9)
    assert clipped == 0.0, f"{clipped:.1%} of samples near full scale"
    # waveform is a sine, not a square: RMS/peak ratio ~ 1/sqrt(2)
    rms = np.sqrt(np.mean(core**2))
    crest = peak / rms
    assert 1.25 < crest < 1.65, f"crest factor {crest} (square wave -> ~1.0)"


def test_mp3_roundtrip_full_scale_not_distorted():
    """A 0.9-amplitude sine must survive without flattening into a square."""
    sr = 48_000
    amp = 0.9
    t = np.arange(sr // 2, dtype=np.float64)
    x = (amp * np.sin(2 * np.pi * 440.0 * t / sr)).astype(np.float32)
    enc = encoders.Mp3Encoder(sr)
    data = enc.encode(x) + _flush(enc)
    enc.close()
    y = _hip_decode(data)
    core = y[2000:-2000]
    rms = np.sqrt(np.mean(core**2))
    expect_rms = amp / np.sqrt(2)
    assert abs(rms - expect_rms) < 0.12 * expect_rms


def test_wav_roundtrip_amplitude():
    sr = 8000
    x = (0.5 * np.sin(2 * np.pi * 100 * np.arange(sr) / sr)).astype(np.float32)
    enc = encoders.WavEncoder(sr)
    pcm = np.frombuffer(enc.encode(x), dtype="<i2").astype(np.float32) / 32767.0
    assert abs(np.abs(pcm).max() - 0.5) < 1e-3


def test_mp3_close_flushes_final_frame():
    """close() drains LAME's final partial frame (the reference never
    flushes — fine for infinite live streams, wrong for finite
    recordings)."""
    enc = encoders.Mp3Encoder(48_000)
    t = np.arange(480, dtype=np.float32) / 48_000
    sine = (0.25 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    body = enc.encode(sine)  # far less than one MP3 frame: stays buffered
    tail = enc.close()
    assert tail, "flush produced no bytes for a buffered partial frame"
    assert enc.close() == b""  # idempotent
    decoded = _hip_decode(body + tail)
    assert decoded.size > 0, "flushed stream did not decode"
