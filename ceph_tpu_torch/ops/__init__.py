"""Device GF(2^8) coding ops of the PyTorch port."""
