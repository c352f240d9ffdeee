"""Audio feature extraction."""
