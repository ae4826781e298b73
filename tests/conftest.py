def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (CUDA kernels have no CPU mode); "
        "skips where torch.cuda.is_available() is False")
