def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's hand-written CUDA kernels); "
        "skips without one — run them with `pytest -m cuda` on the card")
