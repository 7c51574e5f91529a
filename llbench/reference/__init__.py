"""The benchmark's plain reference of LLICTI: the model's rate forward and
training step, and the codec's encoder, in plain PyTorch and numpy.

It imports torch and numpy only: nothing of the measured program, nor of
the JAX package.  It follows the published model (kamisli-icpl/LLICTI:
YCoCg-R lifting, lazy wavelet, one conditional-GMM interpolator per
band, N-lane interleaved rANS) for the configurations the benchmark runs
(three joint colours, normal mixtures, ReLU); any other knob raises.
Parts were frozen from the port's plain code at the commit that added
the benchmark, so that, on the same card and under the same float32
arithmetic, its containers come out byte for byte where the program's
are right.
"""
