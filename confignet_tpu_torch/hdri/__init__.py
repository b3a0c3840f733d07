"""HDRI illumination encoding: a PCA model over log-domain environment maps."""
