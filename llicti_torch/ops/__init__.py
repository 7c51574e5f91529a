"""Colour transform, lazy wavelet, GMM constants and the CDF-table kernel."""
