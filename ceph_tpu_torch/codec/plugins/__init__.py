"""Loadable codec plugins of the port (the `libec_<name>.so` analog set).

Each module here is one plugin: it declares `__erasure_code_version__` and an
`__erasure_code_init__(registry)` entry point, mirroring Ceph's dlopen
contract (src/erasure-code/ErasureCodePlugin.cc:126-163).
"""
