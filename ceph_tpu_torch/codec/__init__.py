"""Erasure codecs of the PyTorch port: contract, base, registry, RS."""
