"""Offline capture demodulation: ``python -m webradio.demod_cli``.

Demodulates a recorded IQ capture to audio files without the server — the
``lax.scan`` offline runner (webradio/pipeline/stream.py) made a tool.
One compiled program processes the whole capture; multiple receivers
demodulate concurrently as a channel batch.

Examples::

  python -m webradio.demod_cli capture.cu8 --rate 2400000 \
      --if-freq 100000 --mode FM -o audio.wav
  python -m webradio.demod_cli capture.npy --rate 1024000 \
      --if-freq -50000 --if-freq 200000 --mode AM --mode USB -o rx

Input formats are those of :class:`webradio.io.source.FileSource`
(.npy complex64 / [N, 2] float32, .cu8/.bin rtl_sdr u8, .cf32 float32).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from . import runtime


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m webradio.demod_cli",
        description="Demodulate a recorded IQ capture to audio (offline, "
                    "whole-capture lax.scan)",
    )
    parser.add_argument("capture", help="IQ capture file (.npy/.cu8/.bin/.cf32)")
    parser.add_argument("--rate", type=int, required=True,
                        help="capture sample rate in Hz")
    parser.add_argument("--if-freq", type=int, action="append", default=[],
                        help="receiver IF offset in Hz (repeat for multiple "
                             "receivers)")
    parser.add_argument("--mode", action="append", default=[],
                        help="demodulator per receiver: AM|FM|USB|LSB "
                             "(repeat to match --if-freq)")
    parser.add_argument("--if-bw", type=int, default=80_000)
    parser.add_argument("--af-bw", type=int, default=8_000)
    parser.add_argument("--channel-rate", type=int, default=None,
                        help="default rate/10")
    parser.add_argument("--audio-rate", type=int, default=48_000)
    parser.add_argument("--block", type=int, default=None,
                        help="scan block frames (default: one ~43 ms block)")
    parser.add_argument("-o", "--output", default="audio",
                        help="output .wav path (single receiver) or prefix")
    parser.add_argument("--engine", choices=("direct", "channelized"),
                        default="direct")
    parser.add_argument("--platform", default=None,
                        choices=sorted(runtime.PLATFORMS),
                        help="pin the JAX backend (default: JAX's choice)")
    args = parser.parse_args(argv)

    runtime.select_platform(args.platform)
    runtime.configure_compile_cache()
    import jax.numpy as jnp

    from .io.source import FileSource
    from .io.soundcard import FileAudioSink
    from .pipeline import ChainConfig, make_receiver_params
    from .pipeline.stream import run_capture
    from .pipeline.channelized import (
        ChannelizedConfig,
        make_channelized_params,
    )

    ifs = args.if_freq or [0]
    modes = args.mode or ["AM"]
    if len(modes) == 1:
        modes = modes * len(ifs)
    if len(modes) != len(ifs):
        parser.error("--mode count must be 1 or match --if-freq count")

    data = FileSource._load(pathlib.Path(args.capture))
    print(f"capture: {len(data)} frames "
          f"({len(data) / args.rate:.2f} s @ {args.rate} Hz), "
          f"{len(ifs)} receiver(s)", file=sys.stderr)

    channel_rate = args.channel_rate or args.rate // 10
    block = args.block or max(
        (args.rate // 23) // 5_120 * 5_120, 5_120
    )
    iq = jnp.asarray(np.stack([data.real, data.imag]).astype(np.float32))

    try:
        return _run(args, parser, ifs, modes, iq, channel_rate, block)
    except ValueError as e:
        parser.error(str(e))


def _run(args, parser, ifs, modes, iq, channel_rate, block):
    import numpy as np

    from .io.soundcard import FileAudioSink
    from .pipeline import ChainConfig, make_receiver_params
    from .pipeline.stream import run_capture
    from .pipeline.channelized import (
        ChannelizedConfig,
        make_channelized_params,
    )

    if args.engine == "channelized":
        from .pipeline.stream import run_capture_channelized

        cfg = ChannelizedConfig(
            sample_rate=args.rate, channel_rate=channel_rate,
            audio_rate=args.audio_rate, block_frames=block,
            num_channels=len(ifs),
        )
        params = make_channelized_params(cfg, ifs, args.if_bw, args.af_bw,
                                         modes)
        _, audio, _ = run_capture_channelized(cfg, params, iq)
        audio = np.asarray(audio)
    else:
        cfg = ChainConfig(
            sample_rate=args.rate, channel_rate=channel_rate,
            audio_rate=args.audio_rate, block_frames=block,
            num_channels=len(ifs),
        )
        params = make_receiver_params(cfg, ifs, args.if_bw, args.af_bw, modes)
        _, audio, _ = run_capture(cfg, params, iq)
        audio = np.asarray(audio)

    out = pathlib.Path(args.output)
    if len(ifs) == 1:
        paths = [out if out.suffix else out.with_suffix(".wav")]
    else:
        paths = [out.parent / f"{out.stem}_{i:02d}.wav"
                 for i in range(len(ifs))]
    for i, p in enumerate(paths):
        sink = FileAudioSink(p, sample_rate=args.audio_rate)
        sink.write(audio[i])
        sink.close()
        print(f"wrote {p} ({audio.shape[-1] / args.audio_rate:.2f} s, "
              f"{modes[i]} @ {ifs[i]:+d} Hz)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
