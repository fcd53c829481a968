"""The benchmark's own tests run here on the CPU at tiny sizes; a test
that needs the card is marked ``gpu`` and skips without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")
