"""webradio — a JAX software-defined-radio framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the C++
``mikestir/webradio`` server: wideband IQ
ingest, spectrum FFT for a browser waterfall, per-receiver NCO downconversion,
FIR channel filtering with decimation, AM/NBFM/SSB demodulation, 48 kHz audio,
MP3 streaming over HTTP, and a JSON REST control API.

Architecture (not a port):

* ``ops``       — pure-functional DSP kernels (FIR design, NCO mix, decimating
                  FIR, overlap-save convolution, demodulators, spectrum FFT),
                  batched over channels, jit/vmap/shard_map friendly.
* ``pipeline``  — the block-program: one jitted ``step(params, state, iq)``
                  per front-end covering spectrum + all receiver channels,
                  with explicit state carries (FIR history, NCO phase, FM
                  previous sample, FFT fill residue).
* ``parallel``  — device-mesh sharding of channels and time blocks with
                  overlap-save halo exchange over ICI.
* ``io``        — sample sources (file replay, synthetic, rtl_tcp network
                  driver) feeding a host-side prefetch ring.
* ``web``       — HTTP server with the reference's REST surface and
                  per-client MP3/WAV audio streaming.
* ``oracle``    — NumPy transliterations of the reference's five inner loops,
                  used as the golden model in tests (never in production).

Reference behavioural anchors are cited throughout as ``file:line`` into the
C++ tree, e.g. ``src/dsp/lowpass.cxx:164-197``.
"""

__version__ = "0.1.0"
