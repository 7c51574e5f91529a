"""Interpolator networks (the GMM parameter CNNs) as ``nn.Module``s."""
