"""OSD-side pieces of the PyTorch port."""
