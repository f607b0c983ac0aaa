"""Random streams and photon sources."""
